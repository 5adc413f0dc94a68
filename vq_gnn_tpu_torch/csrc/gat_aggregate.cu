// GAT attention aggregate over the slot-ELL, for Hopper (sm_90a):
//
//   a[s,k]    = al[clip(col[s,k])] + ar[row_s]
//   ev[s,k]   = exp(leaky_relu(a[s,k], 0.2)) * val[s,k]
//   agg[r,:]  = sum over the cells of row r of ev * x[clip(col), :]
//   rowsum[r] = sum over the cells of row r of ev
//   aggn[r,:], rsn[r] = the same two sums over the cells with a <= 0
//                       (WITH_NEG: the backward's closed form for d_ar needs them)
//
// x is f32, or bf16 or f16 under compute_dtype='bfloat16' or 'float16' (the
// TPU kernel's 16-bit nbrs_flat): its values are widened to f32 in
// registers; al, ar, the sums and the outputs are f32 in every mode.
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_ell.py:_make_fwd_kernel
// (gat=True), reached through gat_aggregate_fused, together with the
// neighbour gather XLA ran in front of it (vq_gnn_tpu/ops/gat.py:377-383).
//
// The column-side logit al is taken per node, precomputed by the caller as
// al = (x @ att_l[:C] + att_l[C]) / scale: the same dot as the TPU kernel's,
// which formed it per cell from the gathered rows only because a 1-D gather
// is slow on the TPU.  Here it is a 4-byte gather per cell.  ar (row side) is
// per node too, (x @ att_r[:C] + att_r[C]) / scale.
//
// What bounds it on the H100: the rate at which its rows' chains of
// dependent loads (offsets, then cells, then al[col] and the gathers) bring
// the gathered rows of x in, mostly from L2.  A live cell costs an exp and
// one or two multiply-adds per channel, far below the 67 TFLOP/s f32 rate.
// At the flagship GAT batch the gathered bytes (live cells x 4*C) arrive at
// 3.5-4.5 TB/s at C = 128 and 256, near the rate kernel 1 (ell_aggregate.cu)
// reaches on the same cells and above device memory's 3.35 TB/s (PERF.md §6
// keeps the numbers): more cells in flight a lane (8) or fewer (2) were
// slower, so fewer bytes a cell is the next lever, not deeper batches.
//
// Design:
// - a group of G lanes per row, rows in index order (a warp per row at
//   C = 128 and 256; 8 or 16 lanes for a narrower x), one float4 of each
//   accumulator per lane per 128 channels, held in registers for the whole
//   row (two of each at C = 256, so a cell's weight is formed once for all
//   its channels).  Wider rows are walked in chunks of 128 channels with the
//   accumulators kept in the row's own outputs (one lane per address, so no
//   barrier);
// - each group loads a window of G cells, takes the live ones (val != 0)
//   from a ballot and gathers their x rows in batches, kLoads cells a batch
//   (kLoads2 at C = 256, where a lane gathers two vectors a cell; kLoads16
//   with one vector of 16-bit values), with the
//   predicated loads of ell_common.cuh.  The predicate is the cell's value,
//   never its weight: each lane loads al[col] of its own cell of the window
//   beside the first batch's gathers and forms ev, and its a <= 0 bit, while
//   they are in flight (formed before the gathers, the kernel was slower).
//   A live cell costs three shuffles (column, weight, bit); slot padding and
//   zero cells cost no load, no shuffle and no arithmetic.  The bits of a
//   window as one ballot were slower: a ballot after the exp held up the
//   batch and doubled the code.  The next window's cells load meanwhile;
// - two warps a block: a block's slot on the SM frees as soon as its two
//   rows are done, not when the slowest of eight is (one warp a block was a
//   little slower); the register budget is pinned by __launch_bounds__;
// - the rows of more than t slots (a list built on the host with the batch,
//   longest first, that carries its threshold t) take a warp each in the
//   first blocks, so the longest chains start first instead of finishing
//   last; the groups in index order skip them by the same t;
// - each output row is written once, by one group; every lane sums the
//   row's live cells in slot order (rowsum and rsn too, from the broadcast
//   weights): no atomics, the same bits in every run, with or without the
//   row offsets and the long-row list, at any G.  Skipping a zero cell is
//   exact (no sum holds -0), which differs from multiplying by 0 only for
//   non-finite x;
// - row offsets (ptr[r] = first slot of row r) come with the batch; a caller
//   without them gets them from row_offsets_kernel first.  They are clamped
//   to [0, S].  Slots of rows >= num_rows (padding) fall outside every range;
//   rows without a slot give 0; padding columns clamp to the last row of x
//   like JAX's mode="clip".  float4 lanes need C % 4 == 0 and 16-byte
//   aligned x, agg and aggn (16-bit lanes of 8 channels, 16 bytes, C % 8 ==
//   0: 16 lanes a row at C = 128, a warp at 256); otherwise a lane covers
//   one channel.

#include "ell_common.cuh"

namespace {

constexpr float kNegSlope = 0.2f;  // PyG GATConv default
constexpr int kThreads = 64;  // two warps a block
constexpr int kLoads = 4;  // cells a batch with one vector a lane
constexpr int kLoads2 = 2;  // cells a batch with two vectors a lane
// 16-bit rows, one vector (8 values) a lane: 2 cells a batch were faster
// than 4 and 8 at C = 128 (bf16), where 16 lanes take a row and 80
// registers hold it
constexpr int kLoads16 = 2;

struct Args {
  const void* x;  // float, bf16_t or f16_t
  int64_t x_rows;
  int C;
  const int *ptr, *col;
  const float* val;
  int64_t S;
  int K;
  const float *al, *ar;
  int64_t num_rows;
  // [1 + n_long]: a threshold, then the rows of more than that many slots,
  // longest first; null for none
  const int* long_rows;
  int64_t n_long;
  float *agg, *rowsum, *aggn, *rsn;  // aggn, rsn: WITH_NEG only
};

// Row r by a group of G lanes (the group's first lane is gbase in the warp).
// NV: the vectors of VEC channels a lane holds, every G * VEC channels;
// WIDE: C is wider than that, walked in chunks; x holds E.
template <typename E, int VEC, int G, int NV, bool WIDE, bool WITH_NEG>
__device__ __forceinline__ void row_aggregate(const Args& a, int64_t r, int gl, int gbase) {
  using V = Row<E, VEC>;
  using T = typename V::T;
  using R = typename V::R;
  const E* x = static_cast<const E*>(a.x);
  constexpr int L = NV == 1 ? (sizeof(E) == 2 ? kLoads16 : kLoads) : kLoads2;  // cells a batch
  constexpr unsigned gbits = 0xffffffffu >> (32 - G);
  constexpr int kStride = G * VEC;  // channels from one of a lane's vectors to the next
  const unsigned gmask = gbits << gbase;
  const int C = a.C;
  const int64_t c0 = slot_at(a.ptr, r, a.S) * a.K;  // cell range of this row
  const int64_t c1 = slot_at(a.ptr, r + 1, a.S) * a.K;
  const int last = (int)(a.x_rows - 1);
  const float ar_r = __ldg(a.ar + r);
  float* aggr = a.agg + r * (int64_t)C;
  float* aggnr = WITH_NEG ? a.aggn + r * (int64_t)C : nullptr;

  T acc[NV], accn[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = accn[v] = V::zero();
  if constexpr (WIDE) {  // the accumulators live in the output rows
    for (int c = gl * VEC; c < C; c += kStride) {
      V::store(aggr + c, V::zero());
      if (WITH_NEG) V::store(aggnr + c, V::zero());
    }
  }

  float rs = 0.f, rsn = 0.f;  // the same in every lane of the group
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
    // this lane's cell: its column, and its al, loaded beside the first
    // batch's gathers (not before them) and used after them
    const bool mine = my_val != 0.f;
    const int my_c = min(max(my_col, 0), last);
    float my_al = 0.f;
    gather(my_al, a.al + my_c, mine);
    // bit j: cell base + j is live; the same in every lane of the group
    unsigned live = (__ballot_sync(gmask, mine) >> gbase) & gbits;
    float my_ev = 0.f;
    int my_neg = 0;  // this lane's cell has a <= 0
    bool first = true;  // the window's first batch
    while (live) {
      const int n = __popc(live);
      int src[L];  // the lanes that own this batch's cells
#pragma unroll
      for (int u = 0; u < L; ++u) {
        src[u] = (__ffs(live) - 1) & (G - 1);
        live &= live - 1;
      }
      R t[L][NV];
      const E* xd[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        xd[u] = x + (int64_t)__shfl_sync(gmask, my_c, src[u], G) * C;
        if constexpr (!WIDE) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = v * kStride + gl * VEC;
            t[u][v] = V::rzero();
            gather(t[u][v], xd[u] + c, u < n && c < C);
          }
        }
      }
      if (first) {  // the window's weights, while the gathers are in flight
        first = false;
        const float av = my_al + ar_r;
        my_ev = mine ? expf(av >= 0.f ? av : kNegSlope * av) * my_val : 0.f;
        if (WITH_NEG) my_neg = mine && av <= 0.f;
      }
      // past the n live cells the weights are 0 (and t = 0)
      float e[L], en[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const float eu = __shfl_sync(gmask, my_ev, src[u], G);
        e[u] = u < n ? eu : 0.f;
        en[u] = WITH_NEG && __shfl_sync(gmask, my_neg, src[u], G) ? e[u] : 0.f;
        rs += e[u];
        if (WITH_NEG) rsn += en[u];
      }
      if constexpr (!WIDE) {
#pragma unroll
        for (int u = 0; u < L; ++u) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            V::fma(acc[v], e[u], t[u][v]);
            if (WITH_NEG) V::fma(accn[v], en[u], t[u][v]);
          }
        }
      } else {
        for (int cb = gl * VEC; cb < C; cb += NV * kStride) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = cb + v * kStride;
#pragma unroll
            for (int u = 0; u < L; ++u) {
              t[u][v] = V::rzero();
              gather(t[u][v], xd[u] + c, u < n && c < C);
            }
          }
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c = cb + v * kStride;
            if (c >= C) continue;
            T s = V::ld(aggr + c);
#pragma unroll
            for (int u = 0; u < L; ++u) V::fma(s, e[u], t[u][v]);
            V::store(aggr + c, s);
            if (WITH_NEG) {
              T sn = V::ld(aggnr + c);
#pragma unroll
              for (int u = 0; u < L; ++u) V::fma(sn, en[u], t[u][v]);
              V::store(aggnr + c, sn);
            }
          }
        }
      }
    }
  }
  if constexpr (!WIDE) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = v * kStride + gl * VEC;
      if (c < C) {
        store_streaming(aggr + c, acc[v]);
        if (WITH_NEG) store_streaming(aggnr + c, accn[v]);
      }
    }
  }
  if (gl == 0) {
    a.rowsum[r] = rs;
    if (WITH_NEG) a.rsn[r] = rsn;
  }
}

// Blocks [0, long_blocks): a warp per long row, in the list's order.  The
// rest: a group of G lanes per row, in index order, skipping the long rows.
// The register budget: 16 blocks an SM (64 registers) with a warp a row and
// the accumulators in registers, the shapes of C = 128 and 256; 12 (80) for
// the narrow groups and the chunked walk, which spill at 64.
template <typename E, int VEC, int G, int NV, bool WIDE, bool WITH_NEG>
__global__ void __launch_bounds__(kThreads, G == 32 && !WIDE ? 16 : 12)
    gat_aggregate_kernel(const Args a, unsigned long_blocks) {
  if (blockIdx.x < long_blocks) {
    const int64_t h = blockIdx.x * (int64_t)(kThreads / 32) + threadIdx.x / 32;
    if (h >= a.n_long) return;
    const int r = __ldg(a.long_rows + 1 + h);
    if (r >= 0 && r < a.num_rows) {
      row_aggregate<E, VEC, 32, NV, WIDE, WITH_NEG>(a, r, threadIdx.x & 31, 0);
    }
    return;
  }
  const int64_t r = ((blockIdx.x - long_blocks) * (int64_t)kThreads + threadIdx.x) / G;
  if (r >= a.num_rows) return;  // the row's whole group leaves together
  // a long row: the list's warp takes it, by the list's own threshold
  if (a.long_rows && __ldg(a.ptr + r + 1) - __ldg(a.ptr + r) > __ldg(a.long_rows)) return;
  row_aggregate<E, VEC, G, NV, WIDE, WITH_NEG>(a, r, threadIdx.x & (G - 1),
                                               threadIdx.x & 31 & ~(G - 1));
}

template <typename E, int VEC, int G, int NV, bool WIDE>
void launch(const Args& a, bool with_neg, cudaStream_t st) {
  const unsigned long_blocks = (unsigned)((a.n_long + kThreads / 32 - 1) / (kThreads / 32));
  const unsigned blocks = long_blocks + (unsigned)((a.num_rows * G + kThreads - 1) / kThreads);
  if (with_neg) {
    gat_aggregate_kernel<E, VEC, G, NV, WIDE, true><<<blocks, kThreads, 0, st>>>(a, long_blocks);
  } else {
    gat_aggregate_kernel<E, VEC, G, NV, WIDE, false><<<blocks, kThreads, 0, st>>>(a,
                                                                                 long_blocks);
  }
}

// G and NV from the vectors of VEC channels a row has: 8 or 16 lanes for a
// narrow x, a warp with one or two vectors a lane up to 64 vectors, and the
// chunked walk of one vector a lane beyond.
template <typename E, int VEC>
void launch_shape(const Args& a, bool with_neg, cudaStream_t st) {
  const int vecs = (a.C + VEC - 1) / VEC;
  if (vecs <= 8) {
    launch<E, VEC, 8, 1, false>(a, with_neg, st);
  } else if (vecs <= 16) {
    launch<E, VEC, 16, 1, false>(a, with_neg, st);
  } else if (vecs <= 32) {
    launch<E, VEC, 32, 1, false>(a, with_neg, st);
  } else if (vecs <= 64) {
    launch<E, VEC, 32, 2, false>(a, with_neg, st);
  } else {
    launch<E, VEC, 32, 1, true>(a, with_neg, st);
  }
}

// 16-bit rows: 8 values a lane where C and the pointers allow
template <typename E>
void launch16(const Args& a, bool with_neg, bool out16, cudaStream_t st) {
  if (a.C % 8 == 0 && aligned16(a.x) && out16) {
    launch_shape<E, 8>(a, with_neg, st);
  } else {
    launch_shape<E, 1>(a, with_neg, st);
  }
}

}  // namespace

// ptr: [num_rows + 1] row offsets; built here from ell_row when build_ptr
// is set, else read as given (clamped to [0, S]).  long_rows: [1 + n_long],
// a threshold t >= 0, then exactly the rows of more than t slots, in the
// order their warps start; null for none.  aggn and rsn are written only
// when with_neg != 0.  x_type: what x holds (RowType: 0 float, 1 bfloat16,
// 2 float16 values).
extern "C" int vq_gat_aggregate(const void* x, int x_type, int64_t x_rows, int C,
                                const int* ell_row,
                                const int* ell_col, const float* ell_val, int64_t S, int K,
                                const float* al, const float* ar, int64_t num_rows,
                                int with_neg, int* ptr, int build_ptr, const int* long_rows,
                                int64_t n_long, float* agg, float* rowsum, float* aggn,
                                float* rsn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  if (K <= 0 || x_rows <= 0 || n_long < 0 || x_type < kRowF32 || x_type > kRowF16)
    return (int)cudaErrorInvalidValue;
  if (build_ptr) launch_row_offsets(ell_row, S, num_rows, ptr, st);
  Args a{x, x_rows, C, ptr, ell_col, ell_val, S, K, al, ar, num_rows,
         long_rows, long_rows ? n_long : 0, agg, rowsum, aggn, rsn};
  const bool out16 = aligned16(agg) && (!with_neg || aligned16(aggn));
  if (x_type == kRowBf16) {
    launch16<bf16_t>(a, with_neg != 0, out16, st);
  } else if (x_type == kRowF16) {
    launch16<f16_t>(a, with_neg != 0, out16, st);
  } else if (C % 4 == 0 && aligned16(x) && out16) {
    launch_shape<float, 4>(a, with_neg != 0, st);
  } else {
    launch_shape<float, 1>(a, with_neg != 0, st);
  }
  return (int)cudaGetLastError();
}
