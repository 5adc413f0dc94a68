// VQ nearest-codeword assignment plus EMA cluster statistics for Hopper
// (sm_90a), all branches in one launch:
//
//   d[b, i, m]   = e2[b, m] - 2 * <xn[b, i, :], emb[b, m, :]>   (no ||x||^2 term)
//   idx[b, i]    = first argmin over m (ties go to the lowest index)
//   counts[b, m] = sum over valid i of [idx[b, i] == m]
//   sums[b, m,:] = sum over valid i of [idx[b, i] == m] * xn[b, i, :]
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_vq.py:_assign_kernel_allb
// (fused_assign_branches) and, run with nb = 1, _assign_kernel (fused_assign).
// e2 is the f32 norm of the unrounded codebook, computed by the caller.  Two
// modes, two kernels:
//
// fast != 0 (the training path): bf16(xn) . bf16(emb) with f32 accumulation,
// and bf16(xn) in the sums, as the Pallas fast mode does.
//   What bounds it: not the products.  Even with K padded to 16 they are
//   ~24 GFLOP at nb=32, B=90k, M=256, microseconds at the tensor-core rate,
//   and the input is ~100 MB.  What sets the time is the epilogue (a compare
//   and two selects per distance, nb*B*M of them, on Hopper's half-rate
//   compare/select pipe) and the statistics.  So:
//   - distances on the tensor cores: mma.sync m16n8k16 bf16 -> f32 (wgmma is
//     not needed at this arithmetic).  A warp keeps the bf16 A fragments of
//     4 tiles of 16 rows in registers for the whole scan over M; K is
//     zero-padded to 16 (one k-step) or 32 (K = 17, two).  The accumulator
//     starts at -e2/2, so the tensor core returns r = x.e - e2/2 = -d/2
//     (halving is exact: r orders the codewords as d does) and the epilogue
//     needs no arithmetic;
//   - the codebook sits in shared memory as bf16 in mma B-fragment order
//     ([n8 tile][lane][2 words per k-step], zero-padded), so each lane loads
//     its fragment with one conflict-free 8- or 16-byte load, with -e2/2 in
//     f32 beside it; M above 1,024 codewords (512 at K = 17) streams through
//     in chunks, the last padded with -e2/2 = -inf;
//   - epilogue per n8 tile: a running (best r, index) with a strict '>' over
//     ascending codewords (a lane holds 2 rows x 2 columns); the 4 lanes of
//     a row then reduce with ties to the lower index;
//   - the next 512-row step's x is loaded into registers while this step
//     scans, so the scan hides its latency;
//   - statistics in O(rows * K) per 512-row step, deterministic, no float
//     atomics.  Warp w owns the codewords m with m % 8 == w.  The step's
//     rows go into a queue sorted by owner warp, then by row (ballot counts
//     per (owner, 32-row chunk), one warp-wide scan, a popc of the lower
//     lanes for the place); warp w then walks its part of the queue 32 rows
//     at a time, groups equal codewords with __match_any_sync, and each
//     group's lowest lane adds the group's rows in row order into the
//     block's [M, K+1] accumulator (in shared memory when it fits, else in
//     the block's own slice of the partials).  Every lane of the walk has a
//     row to add, and a warp issues about two matches per step;
//   - grid: each block walks a contiguous run of whole 512-row steps of one
//     branch; the wrapper picks the run so that the grid is at most two
//     blocks per SM (one wave at nb = 32 and at nb = 1 alike).
// fast == 0 (exact, f32): one thread per row scans all M codewords on the
//   CUDA cores with separately rounded products and sums
//   (__fmul_rn/__fadd_rn, no FMA contraction), the plain PyTorch version's
//   arithmetic, so the two agree bit for bit on the card.  The per-block
//   statistics: thread m sums the rows assigned to codeword m in row order.
// Both modes: invalid rows get an idx but add nothing; a second kernel adds
// the per-block partials in block order.  Summation order of every counts
// and sums cell: rows in order within a block, then blocks in order, so the
// EMA state that carries these sums from step to step is run-to-run
// identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int kMaxK = 17;  // 2*D + 1 for D <= 8
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// exact mode (f32 on the CUDA cores)
// ---------------------------------------------------------------------------

// KT > 0: K known at compile time; KT == 0: runtime K <= kMaxK.
template <int KT, bool SMEM_CB>
__global__ void assign_kernel(const float* __restrict__ xn, const float* __restrict__ emb,
                              const float* __restrict__ e2, const uint8_t* __restrict__ valid,
                              int64_t B, int M, int Krt, int rows, int* __restrict__ idx,
                              float* __restrict__ part) {
  const int K = KT > 0 ? KT : Krt;
  extern __shared__ float smem[];
  // layout: [rows*K] x tile | [rows] idx (as int) | [M*K] codebook | [M] e2
  float* x_s = smem;
  int* idx_s = reinterpret_cast<int*>(x_s + (size_t)rows * K);
  float* emb_s = reinterpret_cast<float*>(idx_s + rows);
  float* e2_s = emb_s + (size_t)M * K;

  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const float* emb_b = emb + (int64_t)b * M * K;
  const float* e2_b = e2 + (int64_t)b * M;
  if (SMEM_CB) {
    for (int i = threadIdx.x; i < M * K; i += blockDim.x) emb_s[i] = emb_b[i];
    for (int i = threadIdx.x; i < M; i += blockDim.x) e2_s[i] = e2_b[i];
    __syncthreads();
  }
  const float* cb = SMEM_CB ? emb_s : emb_b;
  const float* cn = SMEM_CB ? e2_s : e2_b;

  const int64_t row0 = (int64_t)blockIdx.x * rows;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t i = row0 + r;
    int slot = M;  // M = adds nothing to the statistics
    if (i < B) {
      float x[KT > 0 ? KT : kMaxK];
      const float* xr = xn + ((int64_t)b * B + i) * K;
#pragma unroll
      for (int k = 0; k < (KT > 0 ? KT : kMaxK); ++k) {
        if (k < K) {
          x[k] = xr[k];
          x_s[(size_t)r * K + k] = x[k];
        }
      }
      float best = 0.f;
      int bi = 0;
      for (int m = 0; m < M; ++m) {
        const float* e = cb + (size_t)m * K;
        float acc = __fmul_rn(x[0], SMEM_CB ? e[0] : __ldg(e));
#pragma unroll
        for (int k = 1; k < (KT > 0 ? KT : kMaxK); ++k) {
          if (k < K) acc = __fadd_rn(acc, __fmul_rn(x[k], SMEM_CB ? e[k] : __ldg(e + k)));
        }
        const float d = __fsub_rn(SMEM_CB ? cn[m] : __ldg(cn + m), 2.0f * acc);
        if (m == 0 || d < best) {
          best = d;
          bi = m;
        }
      }
      idx[(int64_t)b * B + i] = bi;
      if (valid[i]) slot = bi;
    }
    idx_s[r] = slot;
  }
  __syncthreads();

  // per-block statistics, one codeword per thread, rows in order
  float* out = part + ((int64_t)b * nblk + blockIdx.x) * (int64_t)M * (K + 1);
  const int nrows = (int)min64(rows, B - row0);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float cnt = 0.f;
    float s[KT > 0 ? KT : kMaxK];
#pragma unroll
    for (int k = 0; k < (KT > 0 ? KT : kMaxK); ++k) s[k] = 0.f;
    for (int r = 0; r < nrows; ++r) {
      if (idx_s[r] == m) {
        cnt += 1.f;
#pragma unroll
        for (int k = 0; k < (KT > 0 ? KT : kMaxK); ++k)
          if (k < K) s[k] += x_s[(size_t)r * K + k];
      }
    }
    float* o = out + (int64_t)m * (K + 1);
    o[0] = cnt;
#pragma unroll
    for (int k = 0; k < (KT > 0 ? KT : kMaxK); ++k)
      if (k < K) o[1 + k] = s[k];
  }
}

// ---------------------------------------------------------------------------
// fast mode (bf16 on the tensor cores)
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kMT = 4;                     // 16-row tiles per warp
constexpr int kTile = kWarps * kMT * 16;   // rows per block step (the wrapper's 512)
constexpr int kChunks = kTile / 32;        // 32-row chunks per step, 2 per warp
constexpr int kCounts = kWarps * kChunks;  // (owner warp, chunk) counts per step
static_assert(kChunks == 2 * kWarps && kCounts % 32 == 0, "statistics layout");
constexpr int kChunkBytes = 32 * 1024;     // bf16 codebook chunk in shared memory
constexpr size_t kSmemBudget = 110 * 1024; // two blocks per SM

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// This thread's 2 K values of the step of rows [step, step + kTile) (none
// past row_end): values it * kThreads + threadIdx.x of the step's x.
template <int KMAX>
__device__ __forceinline__ void load_step(float (&pf)[2 * KMAX], const float* __restrict__ x_b,
                                          int64_t step, int64_t row_end, int K) {
  const int nval = (int)min64(kTile, row_end - step) * K;
  const float* xt = x_b + step * K;
#pragma unroll
  for (int it = 0; it < 2 * KMAX; ++it) {
    const int i = it * kThreads + threadIdx.x;
    pf[it] = (it < 2 * K && i < nval) ? __ldg(xt + i) : 0.f;
  }
}

// c += a . b over one 16 x 8 x 16 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Codewords [c0, c0 + mc) of one branch into shared memory: bf16 B fragments
// (tile j, lane l = 4 g + t, k-step s: words (k = 16 s + 2 t, +1) and
// (k = 16 s + 8 + 2 t, +1) of codeword c0 + 8 j + g), zero past M, and
// -e2 / 2 in f32, -inf past M.
template <int KS>
__device__ void stage_chunk(const float* __restrict__ emb_b, const float* __restrict__ e2_b,
                            int M, int K, int c0, int mc, uint32_t* bf_s, float* h_s) {
  for (int i = threadIdx.x; i < mc * 4; i += kThreads) {  // mc / 8 tiles x 32 lanes
    const int lane = i & 31, g = lane >> 2, t = lane & 3;
    const int n = c0 + (i >> 5) * 8 + g;
    const float* e = emb_b + (int64_t)min(n, M - 1) * K;
    uint32_t w[2 * KS];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = s * 16 + h * 8 + 2 * t;
        const float lo = (n < M && k < K) ? e[k] : 0.f;
        const float hi = (n < M && k + 1 < K) ? e[k + 1] : 0.f;
        w[2 * s + h] = pack_bf16(lo, hi);
      }
    }
    if constexpr (KS == 1) {
      reinterpret_cast<uint2*>(bf_s)[i] = make_uint2(w[0], w[1]);
    } else {
      reinterpret_cast<uint4*>(bf_s)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  for (int i = threadIdx.x; i < mc; i += kThreads)
    h_s[i] = c0 + i < M ? -0.5f * e2_b[c0 + i] : -INFINITY;
}

// One block: rows [blockIdx.x * rows, + rows) of branch blockIdx.y, in steps
// of kTile rows.  KT > 0: K known at compile time, KT == 0: runtime K; KS
// k-steps of 16 (K <= 16: 1, K = 17: 2).
//
// The scan maximises r = <x, e> - e2 / 2 = -d / 2: the tensor core starts
// its accumulator at -e2 / 2, so the epilogue is a compare and two selects
// per distance.  Halving is exact, so r orders the codewords as d does; the
// tensor core adds e2 and the products in f32 in its own order.
template <int KT, int KS>
__global__ void __launch_bounds__(kThreads, 2)
assign_fast_kernel(const float* __restrict__ xn, const float* __restrict__ emb,
                   const float* __restrict__ e2, const uint8_t* __restrict__ valid, int64_t B,
                   int M, int Krt, int rows, int mc, int acc_in_smem, int* __restrict__ idx,
                   float* __restrict__ part) {
  constexpr int KMAX = KT > 0 ? KT : (KS == 1 ? 16 : kMaxK);
  const int K = KT > 0 ? KT : Krt;
  // layout: [mc * 8 * KS] B fragments | [mc] -e2/2 | [kTile * K] x step
  // (bf16 values in f32) | [kTile] slots | [kTile] rows by owner warp |
  // [kCounts + 1] queue offsets | [M * (K+1)] accumulator if it fits
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* bf_s = reinterpret_cast<uint32_t*>(smem_raw);
  float* h_s = reinterpret_cast<float*>(bf_s + (size_t)mc * 8 * KS);
  float* x_s = h_s + mc;
  int* slot_s = reinterpret_cast<int*>(x_s + kTile * K);
  int* q_s = slot_s + kTile;
  int* off_s = q_s + kTile;
  float* acc_s = reinterpret_cast<float*>(off_s + kCounts + 1);

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int64_t row_end = min64(row0 + rows, B);
  const float* emb_b = emb + (int64_t)b * M * K;
  const float* e2_b = e2 + (int64_t)b * M;
  const float* x_b = xn + (int64_t)b * B * K;
  const int cells = M * (K + 1);
  float* out = part + ((int64_t)b * gridDim.x + blockIdx.x) * (int64_t)cells;
  float* acc = acc_in_smem ? acc_s : out;
  for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = 0.f;
  const int nchunk = (M + mc - 1) / mc;
  if (nchunk == 1) stage_chunk<KS>(emb_b, e2_b, M, K, 0, mc, bf_s, h_s);
  float pf[2 * KMAX];  // the next step's x, loaded while this step scans
  load_step<KMAX>(pf, x_b, row0, row_end, K);

  for (int64_t step = row0; step < row_end; step += kTile) {
    const int nval = (int)min64(kTile, row_end - step) * K;
#pragma unroll
    for (int it = 0; it < 2 * KMAX; ++it)
      if (it < 2 * K) x_s[it * kThreads + threadIdx.x] = bf16_round(pf[it]);
    __syncthreads();  // x step (and a resident codebook, the accumulator) ready

    // A fragments of this warp's 4 x 16 rows, held for the whole scan
    uint32_t a[kMT][KS][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r0 = (warp * kMT + mt) * 16 + g;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + (q & 1) * 8, k = s * 16 + (q >> 1) * 8 + 2 * t;
          a[mt][s][q] = pack_bf16(k < K ? x_s[r * K + k] : 0.f,
                                  k + 1 < K ? x_s[r * K + k + 1] : 0.f);
        }
      }
    }
    load_step<KMAX>(pf, x_b, step + kTile, row_end, K);
    float best[kMT][2];
    int bi[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      best[mt][0] = best[mt][1] = -INFINITY;
      bi[mt][0] = bi[mt][1] = 0;
    }

    for (int c = 0; c < nchunk; ++c) {
      const int c0 = c * mc;
      if (nchunk > 1) {
        if (c > 0) __syncthreads();  // every warp is done with the last chunk
        stage_chunk<KS>(emb_b, e2_b, M, K, c0, mc, bf_s, h_s);
        __syncthreads();
      }
      const int ntiles = (min(mc, M - c0) + 7) / 8;
#pragma unroll 2
      for (int j = 0; j < ntiles; ++j) {
        uint32_t bw[2 * KS];
        if constexpr (KS == 1) {
          const uint2 v = reinterpret_cast<const uint2*>(bf_s)[j * 32 + lane];
          bw[0] = v.x;
          bw[1] = v.y;
        } else {
          const uint4 v = reinterpret_cast<const uint4*>(bf_s)[j * 32 + lane];
          bw[0] = v.x;
          bw[1] = v.y;
          bw[2] = v.z;
          bw[3] = v.w;
        }
        const float2 hh = *reinterpret_cast<const float2*>(h_s + j * 8 + 2 * t);
        const int n = c0 + j * 8 + 2 * t;  // this lane's columns: n, n + 1
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          // cc[0], cc[1]: row g, columns n, n + 1; cc[2], cc[3]: row g + 8
          float cc[4] = {hh.x, hh.y, hh.x, hh.y};
#pragma unroll
          for (int s = 0; s < KS; ++s) mma_bf16(cc, a[mt][s], bw[2 * s], bw[2 * s + 1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (cc[q] > best[mt][q >> 1]) {
              best[mt][q >> 1] = cc[q];
              bi[mt][q >> 1] = n + (q & 1);
            }
          }
        }
      }
    }

    // first argmin over the 4 lanes of each row; lane t = 0 writes it
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bv = best[mt][h];
        int bx = bi[mt][h];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int ox = __shfl_xor_sync(kFull, bx, off);
          if (ov > bv || (ov == bv && ox < bx)) {
            bv = ov;
            bx = ox;
          }
        }
        const int r = (warp * kMT + mt) * 16 + g + 8 * h;
        if (t == 0) {
          int slot = -1;  // -1 = adds nothing to the statistics
          if (r * K < nval) {
            idx[(int64_t)b * B + step + r] = bx;
            if (valid[step + r]) slot = bx;
          }
          slot_s[r] = slot;
        }
      }
    }
    __syncthreads();  // slots of the whole step ready

    // statistics: warp w adds the rows of its codewords (m % kWarps == w).
    // (1) the rows go into a queue sorted by owner warp, then by row: warp w
    // counts its own two 32-row chunks per owner with ballots, warp 0 scans
    // the (owner, chunk) counts, each row takes its place; (2) warp w walks
    // its part of the queue 32 rows at a time, groups equal codewords with
    // __match_any_sync, and each group's lowest lane adds the group's rows in
    // queue (= row) order
    int owner[2];
    unsigned same[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = warp * 2 + cc;
      const int m = slot_s[c * 32 + lane];
      owner[cc] = m >= 0 ? m % kWarps : -1;
      same[cc] = 0;
#pragma unroll
      for (int o = 0; o < kWarps; ++o) {
        const unsigned bal = __ballot_sync(kFull, owner[cc] == o);
        if (owner[cc] == o) same[cc] = bal;
        if (lane == o) off_s[o * kChunks + c] = __popc(bal);
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the counts in (owner, chunk) order
      int v[kCounts / 32], tot = 0;
#pragma unroll
      for (int u = 0; u < kCounts / 32; ++u) {
        v[u] = off_s[lane * (kCounts / 32) + u];
        tot += v[u];
      }
      int inc = tot;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += y;
      }
      int base = inc - tot;
#pragma unroll
      for (int u = 0; u < kCounts / 32; ++u) {
        off_s[lane * (kCounts / 32) + u] = base;
        base += v[u];
      }
      if (lane == 31) off_s[kCounts] = base;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = warp * 2 + cc;
      if (owner[cc] >= 0)
        q_s[off_s[owner[cc] * kChunks + c] + __popc(same[cc] & ((1u << lane) - 1))] =
            c * 32 + lane;
    }
    __syncthreads();
    const int q_end = off_s[(warp + 1) * kChunks];
    for (int p = off_s[warp * kChunks]; p < q_end; p += 32) {
      const bool live = p + lane < q_end;
      const int m = live ? slot_s[q_s[p + lane]] : -1 - lane;
      const unsigned grp = __match_any_sync(kFull, m);
      if (live && __ffs(grp) - 1 == lane) {
        float* am = acc + (int64_t)m * (K + 1);
        float s[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) s[k] = am[1 + k];
        for (unsigned q = grp; q; q &= q - 1) {
          const float* xr = x_s + q_s[p + __ffs(q) - 1] * K;
#pragma unroll
          for (int k = 0; k < KMAX; ++k)
            if (k < K) s[k] += xr[k];
        }
        am[0] += (float)__popc(grp);
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) am[1 + k] = s[k];
      }
    }
    __syncthreads();  // before the next step overwrites x_s and slot_s
  }
  if (acc_in_smem) {
    for (int i = threadIdx.x; i < cells; i += kThreads) out[i] = acc_s[i];
  }
}

// counts[b, m] / sums[b, m, k] = sum over blocks, in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nb, int nblk, int M,
                                       int K, float* __restrict__ counts,
                                       float* __restrict__ sums) {
  const int64_t per = (int64_t)M * (K + 1);
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= nb * per) return;
  const int64_t b = t / per, rem = t % per;
  float acc = 0.f;
#pragma unroll 8
  for (int blk = 0; blk < nblk; ++blk) acc += part[((int64_t)b * nblk + blk) * per + rem];
  const int64_t m = rem / (K + 1);
  const int j = (int)(rem % (K + 1));
  if (j == 0) {
    counts[b * M + m] = acc;
  } else {
    sums[(b * M + m) * K + (j - 1)] = acc;
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KT, bool SMEM_CB>
cudaError_t launch(const float* xn, const float* emb, const float* e2, const uint8_t* valid,
                   int nb, int64_t B, int M, int K, int rows, int nblk, int* idx, float* part,
                   size_t smem, cudaStream_t st) {
  auto kern = assign_kernel<KT, SMEM_CB>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((unsigned)nblk, (unsigned)nb), kThreads, smem, st>>>(xn, emb, e2, valid, B, M, K,
                                                                   rows, idx, part);
  return cudaGetLastError();
}

template <bool SMEM_CB>
cudaError_t dispatch_k(const float* xn, const float* emb, const float* e2,
                       const uint8_t* valid, int nb, int64_t B, int M, int K, int rows,
                       int nblk, int* idx, float* part, size_t smem, cudaStream_t st) {
  switch (K) {
    case 4:
      return launch<4, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, smem,
                                st);
    case 8:
      return launch<8, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, smem,
                                st);
    case 9:
      return launch<9, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, smem,
                                st);
    default:
      return launch<0, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, smem,
                                st);
  }
}

template <int KT, int KS>
cudaError_t launch_fast(const float* xn, const float* emb, const float* e2, const uint8_t* valid,
                        int nb, int64_t B, int M, int K, int rows, int nblk, int* idx,
                        float* part, cudaStream_t st) {
  const int mc_max = kChunkBytes / (32 * KS);  // a codeword is 16 * KS bf16
  const int mc = M <= mc_max ? (M + 7) / 8 * 8 : mc_max;
  const size_t base = (size_t)mc * 32 * KS + (size_t)mc * sizeof(float) +
                      (size_t)kTile * K * sizeof(float) +
                      (2 * (size_t)kTile + kCounts + 1) * sizeof(int);
  const size_t acc_bytes = (size_t)M * (K + 1) * sizeof(float);
  const bool acc_in_smem = base + acc_bytes <= kSmemBudget;
  const size_t smem = acc_in_smem ? base + acc_bytes : base;
  auto kern = assign_fast_kernel<KT, KS>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((unsigned)nblk, (unsigned)nb), kThreads, smem, st>>>(
      xn, emb, e2, valid, B, M, K, rows, mc, (int)acc_in_smem, idx, part);
  return cudaGetLastError();
}

cudaError_t dispatch_fast(const float* xn, const float* emb, const float* e2,
                          const uint8_t* valid, int nb, int64_t B, int M, int K, int rows,
                          int nblk, int* idx, float* part, cudaStream_t st) {
  switch (K) {
    case 4:
      return launch_fast<4, 1>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, st);
    case 8:
      return launch_fast<8, 1>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, st);
    case 9:
      return launch_fast<9, 1>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, st);
    default:
      return K <= 16
                 ? launch_fast<0, 1>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, st)
                 : launch_fast<0, 2>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, st);
  }
}

}  // namespace

// rows: batch rows per block (fast: a multiple of 512).  part: scratch of
// nb * ceil(B / rows) * M * (K + 1) floats.
extern "C" int vq_assign_stats(const float* xn, const float* emb, const float* e2,
                               const uint8_t* valid, int nb, int64_t B, int M, int K, int fast,
                               int rows, float* part, int* idx, float* counts, float* sums,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || M < 1 || nb < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  if (fast && rows % kTile != 0) return (int)cudaErrorInvalidValue;
  const int nblk = (int)((B + rows - 1) / rows);
  if (nblk > 0) {
    cudaError_t e;
    if (fast) {
      e = dispatch_fast(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part, st);
    } else {
      const size_t tile = (size_t)rows * K * sizeof(float) + (size_t)rows * sizeof(int);
      const size_t cb = (size_t)M * (K + 1) * sizeof(float);
      const bool smem_cb = tile + cb <= 200 * 1024;
      const size_t smem = smem_cb ? tile + cb : tile;
      e = smem_cb ? dispatch_k<true>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part,
                                     smem, st)
                  : dispatch_k<false>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part,
                                      smem, st);
    }
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t total = (int64_t)nb * M * (K + 1);
  reduce_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, nb, nblk, M, K,
                                                                         counts, sums);
  return (int)cudaGetLastError();
}
