// Sorted segment sum for Hopper (sm_90a):
//
//   out[r, :] = sum over slots s with seg[s] == r of part[s, :]   (f32)
//   out_s[r]  = sum over the same slots of scal[s]                 (optional)
//
// seg is ascending; slots whose seg is >= num_rows (padding) are dropped and
// rows that own no slot come out 0.  Either channel may be absent.
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_segsum.py:_make_kernel
// (segment_sum_sorted).  That kernel's 8-aligned windows, one-hot MXU
// reduce, overlap refill and boundary carry work around Mosaic's tiling and
// its sequential grid; none of it is needed here.  Because seg is sorted,
// row r owns the contiguous slot range [ptr[r], ptr[r + 1]), and a run of
// consecutive rows owns one contiguous range.
//
// What bounds it on the H100: device-memory bytes.  One add per input value:
// the least traffic is the live slots' part rows (and scal) read once, the
// row offsets, and out written once, far below any arithmetic limit.  What
// costs beyond that is latency: rows are short (about two slots a row on
// the B + M batch), so a walk row by row keeps one load a lane in flight,
// and a search of seg for each row's range costs log2(S) dependent loads
// before the first (the two searches were about 60 % of the kernel they
// replaced, PERF.md section 6).
//
// Design:
// - row offsets (ptr[r] = first slot of row r) come with the batch, so no
//   row searches; a caller without them gets them from row_offsets_kernel
//   first.  They are clamped to [0, S], so no walk reads past the slots;
// - a group of G lanes takes a tile of kTileRows consecutive rows, which own
//   one contiguous slot range (G = 32 for C = 128, 8 for C = 32: each lane
//   owns VEC consecutive channels, float4 loads where C % 4 == 0 and the
//   pointers are 16-byte aligned, so a slot's partial row is one coalesced
//   group access).  Lane j holds the end of the tile's row j (one coalesced
//   load of the offsets);
// - the group streams that range kLoads slots in flight a lane, across row
//   boundaries, and stores each row's sum once its last slot is in; rows
//   between (no slot) store 0.  Slots past ptr[num_rows] (padding) are
//   never read.  Four rows a tile beat one (a chain per row) and 32 (a long
//   serial walk where rows are long) on the B + M batch;
// - each row's sum starts at 0 and adds its slots in slot order in one lane
//   per channel: no atomics, the same bits in every run, whatever the tile,
//   with or without the long-row list, with ptr given or built;
// - the rows of more than t slots (the batch's list, which carries its
//   threshold t) take a warp each in the first blocks, so a long row starts
//   first instead of finishing last and never shares a warp with another
//   walk; the tiles skip them by the same t.  At C <= 32 that warp takes a
//   channel a lane, which keeps twice the slots in flight in half the
//   registers (same sums, same bits);
// - the register budget allows 4 blocks of 256 threads per SM (64 registers);
// - the scalar channel rides the same walk (a broadcast load per slot),
//   compiled in only where it is given.

#include <climits>

#include "ell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // blocks per SM the register budget allows
constexpr int kLoads = 8;       // slot loads in flight per lane
constexpr int kLongLoads = 16;  // the same in a long row's warp at C <= 32, a channel a lane
constexpr int kTileRows = 4;    // consecutive rows a group walks as one slot range

struct Args {
  const float* part;  // [S, C]; null when C == 0
  int C;
  const float* scal;  // [S] or null
  const int* ptr;
  int64_t S, num_rows;
  // [1 + n_long]: a threshold, then the rows of more than that many slots;
  // null for none
  const int* long_rows;
  int64_t n_long;
  unsigned long_blocks;
  float *out, *out_s;
};

// Rows [r0, r0 + nrows) (nrows <= G) by a group of G lanes (the group's
// first lane is gbase in the warp); with skip_long, the list's long rows
// are left to their own warps.
template <int VEC, int G, bool SCAL, int L>
__device__ __forceinline__ void walk(const Args& a, int64_t r0, int nrows, bool skip_long,
                                     int gl, int gbase) {
  using V = Vec<VEC>;
  constexpr unsigned gbits = 0xffffffffu >> (32 - G);
  const unsigned gmask = gbits << gbase;
  const int s0 = (int)slot_at(a.ptr, r0, a.S);
  const int my_end = gl < nrows ? (int)slot_at(a.ptr, r0 + gl + 1, a.S) : s0;
  unsigned longs = 0;  // bit j: row j is the list's
  if (skip_long) {
    const int prev = __shfl_up_sync(gmask, my_end, 1, G);
    const int len = my_end - (gl == 0 ? s0 : prev);
    longs = (__ballot_sync(gmask, gl < nrows && len > __ldg(a.long_rows)) >> gbase) & gbits;
  }
  for (int cb = 0; cb == 0 || cb < a.C; cb += G * VEC) {
    const int c = cb + gl * VEC;
    const bool vec_on = c < a.C;
    const bool scal_on = SCAL && cb == 0;
    typename V::T acc = V::zero();
    float acc_s = 0.f;
    int j = 0;
    int e = __shfl_sync(gmask, my_end, 0, G);  // the end of row j
    // row j is complete: store it unless it is the list's, go to the next
    auto flush = [&]() {
      if (!(longs >> j & 1)) {
        if (vec_on) V::store(a.out + (r0 + j) * (int64_t)a.C + c, acc);
        if (scal_on && gl == 0) a.out_s[r0 + j] = acc_s;
      }
      acc = V::zero();
      acc_s = 0.f;
      ++j;
      const int nxt = __shfl_sync(gmask, my_end, min(j, nrows - 1), G);
      e = j < nrows ? nxt : INT_MAX;
    };
    int s = s0;
    while (true) {
      while (s >= e) flush();
      if (j >= nrows) break;
      if (longs >> j & 1) {  // the list's warp sums it
        s = e;
        continue;
      }
      // a batch of slots up to the next long row of the tile, or its end
      const unsigned ahead = longs >> j;
      const int lim = __shfl_sync(gmask, my_end, ahead ? j + __ffs(ahead) - 2 : nrows - 1, G);
      typename V::T t[L];
      float ts[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const bool on = s + u < lim;
        t[u] = V::zero();
        ts[u] = 0.f;
        gather(t[u], a.part + (int64_t)(on ? s + u : 0) * a.C + c, on && vec_on);
        if (SCAL) gather(ts[u], a.scal + (on ? s + u : 0), on && scal_on);
      }
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (s + u >= lim) break;
        while (s + u >= e) flush();
        V::fma(acc, 1.f, t[u]);
        if (SCAL) acc_s += ts[u];
      }
      s = min(s + L, lim);
    }
    while (j < nrows) flush();  // the last row, and the rows after it without slots
  }
}

// Blocks [0, long_blocks): a warp per long row, in the list's order.  The
// rest: a group per tile of RT consecutive rows, skipping the long rows.
template <int VEC, int G, int RT, bool SCAL>
__global__ void __launch_bounds__(kThreads, kMinBlocks) segment_sum_kernel(const Args a) {
  const int gl = threadIdx.x & (G - 1);
  const int gbase = threadIdx.x & 31 & ~(G - 1);
  if (blockIdx.x < a.long_blocks) {  // a warp per long row
    const int64_t h = (blockIdx.x * (int64_t)kThreads + threadIdx.x) / 32;
    if (h >= a.n_long) return;
    const int r = __ldg(a.long_rows + 1 + h);
    if (r < 0 || r >= a.num_rows) return;
    if (a.C <= 32) {  // a channel a lane: twice the slots in flight in half the registers
      walk<1, 32, SCAL, kLongLoads>(a, r, 1, false, threadIdx.x & 31, 0);
    } else if ((threadIdx.x & 31) < G) {
      walk<VEC, G, SCAL, kLoads>(a, r, 1, false, gl, 0);
    }
    return;
  }
  const int64_t r0 = ((blockIdx.x - a.long_blocks) * (int64_t)kThreads + threadIdx.x) / G * RT;
  if (r0 >= a.num_rows) return;
  walk<VEC, G, SCAL, kLoads>(a, r0, (int)min64(RT, a.num_rows - r0), a.long_rows != nullptr, gl,
                             gbase);
}

template <int VEC, int G>
void launch(Args a, cudaStream_t st) {
  constexpr int RT = kTileRows < G ? kTileRows : G;
  a.long_blocks = (unsigned)((a.n_long * 32 + kThreads - 1) / kThreads);
  const unsigned tiles = (unsigned)((a.num_rows + RT - 1) / RT);
  const unsigned blocks = a.long_blocks + (tiles * G + kThreads - 1) / kThreads;
  if (a.scal != nullptr) {
    segment_sum_kernel<VEC, G, RT, true><<<blocks, kThreads, 0, st>>>(a);
  } else {
    segment_sum_kernel<VEC, G, RT, false><<<blocks, kThreads, 0, st>>>(a);
  }
}

// G: the lanes one vector per lane needs for C channels (8, 16 or 32).
template <int VEC>
void launch_lanes(const Args& a, cudaStream_t st) {
  const int vecs = (a.C + VEC - 1) / VEC;
  if (vecs <= 8) {
    launch<VEC, 8>(a, st);
  } else if (vecs <= 16) {
    launch<VEC, 16>(a, st);
  } else {
    launch<VEC, 32>(a, st);
  }
}

}  // namespace

// part may be null (C = 0, scalar channel only); scal may be null.  ptr:
// [num_rows + 1] row offsets; built here from seg when build_ptr is set,
// else read as given (clamped to [0, S]).  long_rows: [1 + n_long], a
// threshold t >= 0, then exactly the rows of more than t slots; null for none.
extern "C" int vq_segment_sum(const float* part, int C, const float* scal, const int* seg,
                              int64_t S, int64_t num_rows, int* ptr, int build_ptr,
                              const int* long_rows, int64_t n_long, float* out, float* out_s,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) return (int)cudaGetLastError();
  if (n_long < 0) return (int)cudaErrorInvalidValue;
  if (part == nullptr) C = 0;
  if (C == 0 && scal == nullptr) return (int)cudaGetLastError();  // nothing to sum
  if (build_ptr) launch_row_offsets(seg, S, num_rows, ptr, st);
  Args a{part, C, scal, ptr, S, num_rows, long_rows, long_rows ? n_long : 0, 0u, out, out_s};
  if (C > 0 && C % 4 == 0 && aligned16(part) && aligned16(out)) {
    launch_lanes<4>(a, st);
  } else {
    launch_lanes<1>(a, st);
  }
  return (int)cudaGetLastError();
}
