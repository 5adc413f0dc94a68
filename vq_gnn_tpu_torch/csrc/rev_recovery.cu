// Exact-reverse recovery term of the B + M (v1) formulation for Hopper
// (sm_90a), forward and backward.  Per branch n:
//
//   S_n[b, m] = sum of slot_val[s, k] over the rev-ELL cells (s, k) with
//               slot_row[s] = b and c_indices[slot_col[s, k], n] = m
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
// Replaces the TPU kernels vq_gnn_tpu/ops/pallas_rev.py:_fwd_kernel and
// _bwd_kernel (rev_recovery_info).  The TPU kernels build dense [rows, M]
// codeword histograms with one-hot selects, fold them with MXU matmuls and
// stash the whole pre-relu accumulator ([nb, B_pad, M] f32, ~1.6 GB a layer
// at B_pad = 12,288, M = 1,024) for the backward.  Here no dense grid exists:
// a batch row has only its handful of cells per branch.
//
// What bounds it on the H100: device-memory bytes and latency, far below
// any arithmetic limit (a few flops per cell and branch).  The least
// traffic is the rev-ELL arrays, xb, al, arcb and gbar read once and the
// outputs written once; the per-cell codeword and grad-table reads hit L2
// (c_indices is 10.8 MB at N = 169k, nb = 32; gbar 0.65 MB at M = 1,024).
//
// Design:
// - one warp per branch, walking a chunk of consecutive batch rows; the
//   lanes take 32 of the row's cells at a time.  c_indices is read at each
//   cell's neighbour id here (no [S*K, nb] codeword array is built);
// - equal codewords are merged in a per-warp [M] histogram in shared
//   memory, touched only at the row's own codewords: pass A zeroes them,
//   pass B adds each group of equal codewords (found with __match_any_sync,
//   summed by its lowest lane in lane order) chunk by chunk, pass C visits
//   each distinct codeword once (a NaN marker flags the visited ones) and
//   applies relu, the attention and the Dg-wide dot with gbar;
// - the backward recomputes the merged cells instead of stashing them
//   (three passes over a few cells per row cost less than writing and
//   reading a stash); d_xb and d_al are summed over the warp and written
//   once per (branch, row); d_arcb is summed per warp in a second [M]
//   shared array (each branch owned by one warp, rows in order);
// - info and d_arcb reduce across row chunks: per-chunk partials are added
//   in chunk order by a second kernel.  No atomics: the same result on
//   every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDg = 16;
constexpr int kVisited = 0x7fc0beef;  // a NaN payload no finite sum produces

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ a, int64_t n,
                                               int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(a + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct RevArgs {
  const short* c_indices;  // [N1, nb]
  int64_t n1;
  const int* slot_col;    // [S, K]
  const float* slot_val;  // [S, K]
  const int* slot_row;    // [S] ascending
  int64_t S;
  int K;
  const float* xb;    // [nb, B_pad, Dg]
  const float* al;    // [nb, B_pad]
  const float* arcb;  // [nb, M]
  const float* gbar;  // [nb, M, Dg]
  int nb;
  int64_t B_pad;
  int M;
  int Dg;
  int rows_per_chunk;
};

// One lane's cell of chunk j0 of the row whose cells start at flat index c0:
// live = a real cell (pad cells carry value 0); m = its codeword in branch n.
__device__ __forceinline__ void load_cell(const RevArgs& p, int64_t c0, int ncell, int j,
                                          int n, bool& live, int& m, float& v) {
  live = false;
  m = 0;
  v = 0.f;
  if (j < ncell) {
    v = __ldg(p.slot_val + c0 + j);
    if (v != 0.f) {
      int64_t col = __ldg(p.slot_col + c0 + j);
      col = col < 0 ? 0 : (col >= p.n1 ? p.n1 - 1 : col);
      m = (int)__ldg(p.c_indices + col * p.nb + n);
      m = m < 0 ? 0 : (m >= p.M ? p.M - 1 : m);
      live = true;
    }
  }
}

// Passes A and B over one row: h[m] = S_n[b, m] at the row's codewords.
__device__ __forceinline__ void merge_row(const RevArgs& p, int64_t c0, int ncell, int n,
                                          int lane, float* h) {
  for (int j0 = 0; j0 < ncell; j0 += 32) {
    bool live;
    int m;
    float v;
    load_cell(p, c0, ncell, j0 + lane, n, live, m, v);
    if (live) h[m] = 0.f;
  }
  __syncwarp();
  for (int j0 = 0; j0 < ncell; j0 += 32) {
    bool live;
    int m;
    float v;
    load_cell(p, c0, ncell, j0 + lane, n, live, m, v);
    const unsigned grp = __match_any_sync(kFull, live ? m : -1 - lane);
    float sum = 0.f;
    for (int src = 0; src < 32; ++src) {
      const float vs = __shfl_sync(kFull, v, src);
      if ((grp >> src) & 1u) sum += vs;
    }
    if (live && (__ffs(grp) - 1) == lane) h[m] += sum;
    __syncwarp();
  }
}

// BWD = false: part[chunk, n] = this warp's share of info[n].
// BWD = true:  d_xb, d_al for the chunk's rows (times g[n]) and
//              part[chunk, n, :] = this warp's share of d_arcb[n, :] / g[n].
template <bool BWD>
__global__ void rev_kernel(RevArgs p, const float* __restrict__ g, float* __restrict__ d_xb,
                           float* __restrict__ d_al, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.y * warps + w;
  if (n >= p.nb) return;  // whole warp; no block-wide barrier follows
  const int M = p.M, Dg = p.Dg;
  float* h = smem + (size_t)w * (BWD ? 2 : 1) * M;
  float* dacc = h + M;  // BWD only
  if (BWD) {
    for (int m = lane; m < M; m += 32) dacc[m] = 0.f;
    __syncwarp();
  }
  const int64_t chunk = blockIdx.x;
  const int64_t b0 = chunk * p.rows_per_chunk;
  const int64_t b1 = b0 + p.rows_per_chunk < p.B_pad ? b0 + p.rows_per_chunk : p.B_pad;
  const float gn = BWD ? __ldg(g + n) : 0.f;
  const float* gbar_n = p.gbar + (int64_t)n * M * Dg;
  const float* arcb_n = p.arcb + (int64_t)n * M;
  float info_acc = 0.f;

  int64_t s0 = lower_bound(p.slot_row, p.S, b0);
  for (int64_t b = b0; b < b1; ++b) {
    int64_t s1 = s0;
    while (s1 < p.S && __ldg(p.slot_row + s1) == b) ++s1;
    const int64_t c0 = s0 * p.K;
    const int ncell = (int)((s1 - s0) * p.K);
    s0 = s1;
    float xr[kMaxDg];
    const float* xb_row = p.xb + ((int64_t)n * p.B_pad + b) * Dg;
#pragma unroll
    for (int d = 0; d < kMaxDg; ++d) xr[d] = d < Dg ? __ldg(xb_row + d) : 0.f;
    const float al_b = __ldg(p.al + (int64_t)n * p.B_pad + b);
    float dx[BWD ? kMaxDg : 1];
#pragma unroll
    for (int d = 0; d < (BWD ? kMaxDg : 1); ++d) dx[d] = 0.f;
    float dal = 0.f;

    if (ncell > 0) {
      merge_row(p, c0, ncell, n, lane, h);
      __syncwarp();
      // pass C: each distinct codeword of the row once
      for (int j0 = 0; j0 < ncell; j0 += 32) {
        bool live;
        int m;
        float v;
        load_cell(p, c0, ncell, j0 + lane, n, live, m, v);
        const unsigned grp = __match_any_sync(kFull, live ? m : -1 - lane);
        if (live && (__ffs(grp) - 1) == lane && __float_as_int(h[m]) != kVisited) {
          const float s = h[m];
          h[m] = __int_as_float(kVisited);
          if (s > 0.f) {
            const float a = al_b + __ldg(arcb_n + m);
            const float att = expf(a >= 0.f ? a : 0.2f * a);
            const float satt = s * att;
            const float* gb = gbar_n + (int64_t)m * Dg;
            float G = 0.f;
#pragma unroll
            for (int d = 0; d < kMaxDg; ++d) {
              if (d < Dg) {
                const float gd = __ldg(gb + d);
                G += xr[d] * gd;
                if constexpr (BWD) dx[d] += satt * gd;
              }
            }
            if (BWD) {
              const float da = satt * (a >= 0.f ? 1.f : 0.2f) * G;
              dal += da;
              dacc[m] += da;
            } else {
              info_acc += satt * G;
            }
          }
        }
        __syncwarp();
      }
    }
    if constexpr (BWD) {
      float* dxo = d_xb + ((int64_t)n * p.B_pad + b) * Dg;
#pragma unroll
      for (int d = 0; d < kMaxDg; ++d) {
        if (d < Dg) {
          const float t = warp_sum(dx[d]);
          if (lane == 0) dxo[d] = gn * t;
        }
      }
      const float t = warp_sum(dal);
      if (lane == 0) d_al[(int64_t)n * p.B_pad + b] = gn * t;
    }
  }
  if (BWD) {
    __syncwarp();
    float* o = part + (chunk * p.nb + n) * (int64_t)M;
    for (int m = lane; m < M; m += 32) o[m] = dacc[m];
  } else {
    const float t = warp_sum(info_acc);
    if (lane == 0) part[chunk * p.nb + n] = t;
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

template <bool BWD>
cudaError_t launch(const RevArgs& p, int warps, const float* g, float* d_xb, float* d_al,
                   float* part, cudaStream_t st) {
  const size_t smem = (size_t)warps * (BWD ? 2 : 1) * p.M * sizeof(float);
  auto kern = rev_kernel<BWD>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t chunks = (p.B_pad + p.rows_per_chunk - 1) / p.rows_per_chunk;
  const dim3 grid((unsigned)chunks, (unsigned)((p.nb + warps - 1) / warps));
  kern<<<grid, warps * 32, smem, st>>>(p, g, d_xb, d_al, part);
  return cudaGetLastError();
}

RevArgs make_args(const short* c_indices, int64_t n1, const int* slot_col,
                  const float* slot_val, const int* slot_row, int64_t S, int K,
                  const float* xb, const float* al, const float* arcb, const float* gbar,
                  int nb, int64_t B_pad, int M, int Dg, int rows_per_chunk) {
  RevArgs p;
  p.c_indices = c_indices;
  p.n1 = n1;
  p.slot_col = slot_col;
  p.slot_val = slot_val;
  p.slot_row = slot_row;
  p.S = S;
  p.K = K;
  p.xb = xb;
  p.al = al;
  p.arcb = arcb;
  p.gbar = gbar;
  p.nb = nb;
  p.B_pad = B_pad;
  p.M = M;
  p.Dg = Dg;
  p.rows_per_chunk = rows_per_chunk;
  return p;
}

bool bad_args(int nb, int64_t B_pad, int M, int Dg, int K, int rows_per_chunk, int warps) {
  return nb < 1 || B_pad < 1 || M < 1 || Dg < 1 || Dg > kMaxDg || K < 1 ||
         rows_per_chunk < 1 || warps < 1 || warps > 32;
}

}  // namespace

// Forward.  part: scratch of ceil(B_pad / rows_per_chunk) * nb floats.
extern "C" int vq_rev_forward(const short* c_indices, int64_t n1, const int* slot_col,
                              const float* slot_val, const int* slot_row, int64_t S, int K,
                              const float* xb, const float* al, const float* arcb,
                              const float* gbar, int nb, int64_t B_pad, int M, int Dg,
                              int rows_per_chunk, int warps, float* part, float* info,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(nb, B_pad, M, Dg, K, rows_per_chunk, warps)) return (int)cudaErrorInvalidValue;
  const RevArgs p = make_args(c_indices, n1, slot_col, slot_val, slot_row, S, K, xb, al, arcb,
                              gbar, nb, B_pad, M, Dg, rows_per_chunk);
  cudaError_t e = launch<false>(p, warps, nullptr, nullptr, nullptr, part, st);
  if (e != cudaSuccess) return (int)e;
  const int64_t chunks = (B_pad + rows_per_chunk - 1) / rows_per_chunk;
  reduce_chunks_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(part, chunks, nb, 1,
                                                                     nullptr, info);
  return (int)cudaGetLastError();
}

// Backward.  part: scratch of ceil(B_pad / rows_per_chunk) * nb * M floats.
extern "C" int vq_rev_backward(const short* c_indices, int64_t n1, const int* slot_col,
                               const float* slot_val, const int* slot_row, int64_t S, int K,
                               const float* xb, const float* al, const float* arcb,
                               const float* gbar, int nb, int64_t B_pad, int M, int Dg,
                               int rows_per_chunk, int warps, const float* g, float* part,
                               float* d_xb, float* d_al, float* d_arcb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(nb, B_pad, M, Dg, K, rows_per_chunk, warps)) return (int)cudaErrorInvalidValue;
  const RevArgs p = make_args(c_indices, n1, slot_col, slot_val, slot_row, S, K, xb, al, arcb,
                              gbar, nb, B_pad, M, Dg, rows_per_chunk);
  cudaError_t e = launch<true>(p, warps, g, d_xb, d_al, part, st);
  if (e != cudaSuccess) return (int)e;
  const int64_t chunks = (B_pad + rows_per_chunk - 1) / rows_per_chunk;
  const int64_t total = (int64_t)nb * M;
  reduce_chunks_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, chunks, total, M,
                                                                        g, d_arcb);
  return (int)cudaGetLastError();
}
