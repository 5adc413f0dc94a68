// Slot-ELL aggregate for Hopper (sm_90a):
//
//   out[r, :] = sum over slots s of row r, sum over k < K of
//               val[s, k] * x[clip(col[s, k]), :]            (f32 accumulation)
//
// x is f32, or bf16 or f16 under compute_dtype='bfloat16' or 'float16' (the
// TPU kernel's 16-bit nbrs_flat): its values are widened to f32 in
// registers, so the sums and out stay f32 in every mode.
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_ell.py:_make_fwd_kernel
// (gat=False), reached through _ell_fused_impl / ell_aggregate_fused, together
// with the neighbour gather XLA ran in front of it (vq_gnn_tpu/ops/spmm.py:186).
// The same kernel runs over the transposed ELL for the backward dx.
//
// What bounds it on the H100: the latency of its dependent loads.  Each live
// cell does one multiply-add per channel, far below the 67 TFLOP/s f32 rate,
// and gathers a row of x that L2 mostly holds: at the flagship batch the time
// does not move when x's rows are scattered in memory, and a narrow x that
// fits in L2 is no faster per gathered byte than one that does not
// (PERF.md §6).  What costs is each row's chain: its offsets, then its
// cells, then the gathers; and the long rows (up to 688 cells in a batch
// whose median is 7) that a warp walks one batch of gathers at a time.
//
// Design:
// - a group of G lanes per row, one vector of VEC channels per lane (G = 32
//   and float4 at C = 128; 8 or 16 lanes for a narrower x; 16-bit rows take
//   8 channels, 16 bytes, a lane: 16 lanes at C = 128), rows in index
//   order, so neighbouring rows, which share neighbours, gather together;
// - each group loads a window of G cells, takes the live ones (val != 0)
//   from a ballot and gathers kLoads of them per lane (kLoads16 of 16-bit
//   rows) before the first FMA
//   waits (predicated loads in volatile asm, so the compiler neither sinks
//   them into a branch nor merges them with their use); slot padding and
//   zero cells cost no load, and the row ends at its last live cell.  The
//   next window's cells load while this window's gathers are in flight;
// - the rows of more than t slots (a list built on the host, longest first,
//   that carries its threshold t) take a warp each in the first blocks, so
//   the longest chains start first instead of finishing last; the groups in
//   index order skip them by the same t;
// - the register budget allows 4 blocks of 256 threads per SM (64 registers):
//   with it ptxas keeps the gathers in flight at twice the occupancy a free
//   budget gives;
// - each (row, channel) sums the row's live cells in slot order, one FMA
//   each, in one thread: no atomics, the same bits in every run, at every
//   panel count, with or without the long-row list.  Skipping a zero cell is exact
//   (the sum never holds -0, so adding 0 * 0 changes no bit), which differs
//   from multiplying by 0 only for non-finite x;
// - channels wider than 32 vectors split into panels (blockIdx.y), each
//   walked by its own groups; at C <= 128 there is one;
// - row offsets (ptr[r] = first slot of row r) come with the batch, built on
//   the host; a caller without them gets them from row_offsets_kernel first.
//   They are clamped to [0, S], so no row reads past the ELL arrays.
//   Slots with row >= num_rows (padding, the backward's ride-over dustbin)
//   fall outside every range and are dropped; rows without a slot give 0;
// - padding columns equal the row count of x, one past its end: they clamp
//   to the last row like JAX's mode="clip", so nothing is read out of bounds.
//   float4 lanes need C % 4 == 0 and 16-byte aligned x and out, 16-bit lanes
//   of 8 C % 8 == 0; otherwise a lane covers one channel (VEC = 1).

#include "ell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks per SM the register budget allows
constexpr int kLoads = 8;      // gathers in flight per lane
// with 16-bit rows: a 16-byte gather holds 8 values, and 8 in flight spilled
// at the 64-register budget; 4 were faster than 8 and 6 at C = 128 (bf16)
constexpr int kLoads16 = 4;

struct Args {
  const void* x;  // float, bf16_t or f16_t
  int64_t x_rows;
  int C, Cp;  // channels, channels per panel
  const int *ptr, *col;
  const float* val;
  int64_t S;
  int K;
  int64_t num_rows;
  // [1 + n_long]: a threshold, then the rows of more than that many slots,
  // longest first; null for none
  const int* long_rows;
  int64_t n_long;
  unsigned long_blocks;
  float* out;
};

// Row r over channels [p0, p1) by a group of G lanes (the group's first lane
// is gbase in the warp), each lane VEC channels of every G * VEC; x holds E.
template <typename E, int VEC, int G>
__device__ __forceinline__ void row_sum(const Args& a, int64_t r, int p0, int p1, int gl,
                                        int gbase) {
  using V = Row<E, VEC>;
  constexpr int L = sizeof(E) == 2 ? kLoads16 : kLoads;  // gathers in flight per lane
  const E* x = static_cast<const E*>(a.x);
  constexpr unsigned gbits = 0xffffffffu >> (32 - G);
  const unsigned gmask = gbits << gbase;
  const int64_t c0 = slot_at(a.ptr, r, a.S) * a.K;  // cell range of this row
  const int64_t c1 = slot_at(a.ptr, r + 1, a.S) * a.K;
  const int last = (int)(a.x_rows - 1);
  for (int cb = p0; cb < p1; cb += G * VEC) {
    const int c = cb + gl * VEC;
    const bool on = c < p1;
    typename V::T acc = V::zero();
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
      // bit j: cell base + j is live; the same in every lane of the group
      unsigned live = (__ballot_sync(gmask, my_val != 0.f) >> gbase) & gbits;
      while (live) {
        const int n = __popc(live);
        float v[L];
        typename V::R t[L];
#pragma unroll
        for (int u = 0; u < L; ++u) {
          const int j = (__ffs(live) - 1) & (G - 1);
          live &= live - 1;
          const float vu = __shfl_sync(gmask, my_val, j, G);
          v[u] = u < n ? vu : 0.f;
          const int cc = min(max(__shfl_sync(gmask, my_col, j, G), 0), last);
          t[u] = V::rzero();
          gather(t[u], x + (int64_t)cc * a.C + c, u < n && on);
        }
        // past the n live cells v = t = 0: adding 0 * 0 changes no bit
#pragma unroll
        for (int u = 0; u < L; ++u) V::fma(acc, v[u], t[u]);
      }
    }
    if (on) store_streaming(a.out + r * (int64_t)a.C + c, acc);
  }
}

// Blocks [0, long_blocks): a warp per long row, in the list's order.  The
// rest: a group of G lanes per row, in index order, skipping the long rows.
// blockIdx.y: the channel panel.
template <typename E, int VEC, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ell_aggregate_kernel(const Args a) {
  const int p0 = blockIdx.y * a.Cp;
  const int p1 = min(a.C, p0 + a.Cp);
  if (blockIdx.x < a.long_blocks) {
    const int64_t h = blockIdx.x * (int64_t)(kThreads / 32) + threadIdx.x / 32;
    if (h >= a.n_long) return;
    const int r = __ldg(a.long_rows + 1 + h);
    if (r >= 0 && r < a.num_rows) row_sum<E, VEC, 32>(a, r, p0, p1, threadIdx.x & 31, 0);
    return;
  }
  const int64_t r = ((blockIdx.x - a.long_blocks) * (int64_t)kThreads + threadIdx.x) / G;
  if (r >= a.num_rows) return;  // the row's whole group leaves together
  // a long row: the list's warp sums it, by the list's own threshold
  if (a.long_rows && __ldg(a.ptr + r + 1) - __ldg(a.ptr + r) > __ldg(a.long_rows)) return;
  row_sum<E, VEC, G>(a, r, p0, p1, threadIdx.x & (G - 1), threadIdx.x & 31 & ~(G - 1));
}

template <typename E, int VEC, int G>
void launch(Args a, cudaStream_t st) {
  a.long_blocks = (unsigned)((a.n_long + kThreads / 32 - 1) / (kThreads / 32));
  const dim3 grid(a.long_blocks + (unsigned)((a.num_rows * G + kThreads - 1) / kThreads),
                  (unsigned)((a.C + a.Cp - 1) / a.Cp));
  ell_aggregate_kernel<E, VEC, G><<<grid, kThreads, 0, st>>>(a);
}

// G: the lanes one vector per lane needs for a panel (8, 16 or 32).
template <typename E, int VEC>
void launch_lanes(const Args& a, cudaStream_t st) {
  const int vecs = (a.Cp + VEC - 1) / VEC;
  if (vecs <= 8) {
    launch<E, VEC, 8>(a, st);
  } else if (vecs <= 16) {
    launch<E, VEC, 16>(a, st);
  } else {
    launch<E, VEC, 32>(a, st);
  }
}

// 16-bit rows: 8 values a lane where C, the panel and the pointers allow
template <typename E>
void launch16(const Args& a, cudaStream_t st) {
  if (a.C % 8 == 0 && a.Cp % 8 == 0 && aligned16(a.x) && aligned16(a.out)) {
    launch_lanes<E, 8>(a, st);
  } else {
    launch_lanes<E, 1>(a, st);
  }
}

}  // namespace

// ptr: [num_rows + 1] row offsets; built here from ell_row when build_ptr is
// set, else read as given (clamped to [0, S]).  long_rows: [1 + n_long], a
// threshold t >= 0, then exactly the rows of more than t slots, in the order
// their warps start; null for none.  Cp: channels per panel (> 0; a multiple
// of 4 for the float4 lanes, of 8 for the 16-bit lanes; a row group walks
// panels wider than 32 vectors in chunks).  x_type: what x holds (RowType:
// 0 float, 1 bfloat16, 2 float16 values).
extern "C" int vq_ell_aggregate(const void* x, int x_type, int64_t x_rows, int C, int Cp,
                                const int* ell_row, const int* ell_col, const float* ell_val,
                                int64_t S, int K, int64_t num_rows, int* ptr, int build_ptr,
                                const int* long_rows, int64_t n_long, float* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  if (Cp <= 0 || Cp > C || K <= 0 || n_long < 0 || x_type < kRowF32 || x_type > kRowF16)
    return (int)cudaErrorInvalidValue;
  if (build_ptr) launch_row_offsets(ell_row, S, num_rows, ptr, st);
  Args a{x, x_rows, C, Cp, ptr, ell_col, ell_val, S, K, num_rows, long_rows,
         long_rows ? n_long : 0, 0u, out};
  if (x_type == kRowBf16) {
    launch16<bf16_t>(a, st);
  } else if (x_type == kRowF16) {
    launch16<f16_t>(a, st);
  } else if (C % 4 == 0 && Cp % 4 == 0 && aligned16(x) && aligned16(out)) {
    launch_lanes<float, 4>(a, st);
  } else {
    launch_lanes<float, 1>(a, st);
  }
  return (int)cudaGetLastError();
}
