// Slot-ELL aggregate for Hopper (sm_90a):
//
//   out[r, :] = sum over slots s of row r, sum over k < K of
//               val[s, k] * x[clip(col[s, k]), :]            (f32 accumulation)
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_ell.py:_make_fwd_kernel
// (gat=False), reached through _ell_fused_impl / ell_aggregate_fused, together
// with the neighbour gather XLA ran in front of it (vq_gnn_tpu/ops/spmm.py:186).
// The same kernel runs over the transposed ELL for the backward dx.
//
// What bounds it on the H100: device-memory bytes.  Each cell does one
// multiply-add per channel, so the work is far below the 67 TFLOP/s f32 rate;
// the least traffic is x, the ELL arrays and out once each.  The gather reads
// a 4*C-byte row of x per non-zero cell, which L2 (50 MB) catches only in
// part, so the kernel moves more than that least traffic.
//
// Design:
// - the gather is fused: each warp reads x[col] rows straight into registers,
//   so the [S*K, C] neighbour block the JAX path materialised (~1.1 GB at the
//   arxiv-scale batch) never exists;
// - one warp per output row, C/32 channels per lane (float4 loads when C is a
//   multiple of 4 and the pointers are 16-byte aligned).  The warp walks its
//   row's slot range and writes the row once: no atomics, so the result is
//   deterministic.  Rows with no slot come out 0;
// - slot ranges come from a first small kernel that turns the ascending
//   ell_row into row offsets (rows >= num_rows, the padding dustbin, are
//   dropped); cells with val == 0 (slot padding) are skipped, which differs
//   from multiplying by 0 only for non-finite x;
// - padding columns equal the row count of x, one past its end: they clamp
//   to the last row like JAX's mode="clip", so nothing is read out of bounds.

#include "ell_common.cuh"

namespace {

constexpr int kUnroll = 4;  // x rows in flight per lane

template <int VEC>
__global__ void ell_aggregate_kernel(const float* __restrict__ x, int64_t x_rows, int C,
                                     const int* __restrict__ ptr,
                                     const int* __restrict__ col,
                                     const float* __restrict__ val, int K,
                                     int64_t num_rows, float* __restrict__ out) {
  using V = Vec<VEC>;
  const int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= num_rows) return;  // whole warp leaves together
  const int64_t c0 = (int64_t)ptr[r] * K;  // cell range of this row
  const int64_t c1 = (int64_t)ptr[r + 1] * K;
  const int last = (int)(x_rows - 1);

  for (int cb = 0; cb < C; cb += 32 * VEC) {
    const int c = cb + lane * VEC;
    const bool live = c < C;
    typename V::T acc = V::zero();
    for (int64_t base = c0; base < c1; base += 32) {
      // the warp loads 32 cells at once, then broadcasts them one by one
      const int64_t cell = base + lane;
      int my_col = 0;
      float my_val = 0.f;
      if (cell < c1) {
        my_col = col[cell];
        my_val = val[cell];
      }
      const int n = (int)min64(32, c1 - base);
      for (int j = 0; j < n; j += kUnroll) {
        float v[kUnroll];
        typename V::T t[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = j + u;
          const float vv = __shfl_sync(0xffffffffu, my_val, jj & 31);
          const int cc = __shfl_sync(0xffffffffu, my_col, jj & 31);
          v[u] = jj < n ? vv : 0.f;
          const int cl = min(max(cc, 0), last);
          t[u] = (v[u] != 0.f && live) ? V::load(x + (int64_t)cl * C + c) : V::zero();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) V::fma(acc, v[u], t[u]);
      }
    }
    if (live) V::store(out + r * (int64_t)C + c, acc);
  }
}

}  // namespace

extern "C" int vq_ell_aggregate(const float* x, int64_t x_rows, int C, const int* ell_row,
                                const int* ell_col, const float* ell_val, int64_t S, int K,
                                int64_t num_rows, int* ptr, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  launch_row_offsets(ell_row, S, num_rows, ptr, st);
  const int threads = 256;  // 8 rows per block
  const unsigned blocks = (unsigned)((num_rows * 32 + threads - 1) / threads);
  const bool vec4 = C % 4 == 0 && aligned16(x) && aligned16(out);
  if (vec4) {
    ell_aggregate_kernel<4><<<blocks, threads, 0, st>>>(x, x_rows, C, ptr, ell_col, ell_val,
                                                        K, num_rows, out);
  } else {
    ell_aggregate_kernel<1><<<blocks, threads, 0, st>>>(x, x_rows, C, ptr, ell_col, ell_val,
                                                        K, num_rows, out);
  }
  return (int)cudaGetLastError();
}
