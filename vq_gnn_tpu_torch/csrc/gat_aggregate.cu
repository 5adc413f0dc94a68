// GAT attention aggregate over the slot-ELL, for Hopper (sm_90a):
//
//   a[s,k]    = al[clip(col[s,k])] + ar[row_s]
//   ev[s,k]   = exp(leaky_relu(a[s,k], 0.2)) * val[s,k]
//   agg[r,:]  = sum over the cells of row r of ev * x[clip(col), :]
//   rowsum[r] = sum over the cells of row r of ev
//   aggn[r,:], rsn[r] = the same two sums over the cells with a <= 0
//                       (WITH_NEG: the backward's closed form for d_ar needs them)
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
// What bounds it on the H100: device-memory bytes.  A cell costs an exp and
// one or two multiply-adds per channel, far below the 67 TFLOP/s f32 rate;
// the least traffic is x, al, ar, the ELL arrays and the outputs once each.
// The gather reads a 4*C-byte row of x per non-zero cell, which L2 (50 MB)
// catches only in part, so the kernel moves more than that least traffic.
//
// Design (that of ell_aggregate.cu):
// - one warp per output row, C/32 channels per lane (float4 loads when C is a
//   multiple of 4 and the pointers are 16-byte aligned); the warp walks its
//   row's slot range, 32 cells at a time: each lane forms a, ev (and the
//   masked ev) of one cell, then the warp broadcasts them and reads the x rows
//   straight into registers, so the [S*K, C] gathered block never exists;
// - every output row is written once by its warp: no atomics, deterministic;
// - row ranges come from the sorted ell_row (row_offsets_kernel); rows >=
//   num_rows (padding) are dropped; cells with val == 0 (slot padding) are
//   skipped, which differs from multiplying by 0 only for non-finite x;
//   padding columns clamp to the last row of x like JAX's mode="clip".

#include "ell_common.cuh"

namespace {

constexpr float kNegSlope = 0.2f;  // PyG GATConv default
constexpr int kUnroll = 4;  // x rows in flight per lane

template <int VEC, bool WITH_NEG>
__global__ void gat_aggregate_kernel(const float* __restrict__ x, int64_t x_rows, int C,
                                     const int* __restrict__ ptr,
                                     const int* __restrict__ col,
                                     const float* __restrict__ val, int K,
                                     const float* __restrict__ al,
                                     const float* __restrict__ ar, int64_t num_rows,
                                     float* __restrict__ agg, float* __restrict__ rowsum,
                                     float* __restrict__ aggn, float* __restrict__ rsn) {
  using V = Vec<VEC>;
  const int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= num_rows) return;  // whole warp leaves together
  const int64_t c0 = (int64_t)ptr[r] * K;  // cell range of this row
  const int64_t c1 = (int64_t)ptr[r + 1] * K;
  const int last = (int)(x_rows - 1);
  const float ar_r = ar[r];
  float rs = 0.f, rs_neg = 0.f;  // this lane's share of rowsum / rsn

  for (int cb = 0; cb < C; cb += 32 * VEC) {
    const int c = cb + lane * VEC;
    const bool live = c < C;
    typename V::T acc = V::zero(), acc_neg = V::zero();
    for (int64_t base = c0; base < c1; base += 32) {
      // each lane forms the attention value of one of the next 32 cells
      const int64_t cell = base + lane;
      int my_col = 0;
      float my_ev = 0.f, my_evn = 0.f;
      if (cell < c1) {
        const float v = val[cell];
        if (v != 0.f) {
          my_col = min(max(col[cell], 0), last);
          const float a = al[my_col] + ar_r;
          my_ev = expf(a >= 0.f ? a : kNegSlope * a) * v;
          if (WITH_NEG) my_evn = a <= 0.f ? my_ev : 0.f;
        }
      }
      if (cb == 0) {
        rs += my_ev;
        if (WITH_NEG) rs_neg += my_evn;
      }
      const int n = (int)min64(32, c1 - base);
      for (int j = 0; j < n; j += kUnroll) {
        float e[kUnroll], en[kUnroll];
        typename V::T t[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = j + u;
          const float ee = __shfl_sync(0xffffffffu, my_ev, jj & 31);
          const float eneg = __shfl_sync(0xffffffffu, my_evn, jj & 31);
          const int cc = __shfl_sync(0xffffffffu, my_col, jj & 31);
          e[u] = jj < n ? ee : 0.f;
          en[u] = jj < n ? eneg : 0.f;
          t[u] = (e[u] != 0.f && live) ? V::load(x + (int64_t)cc * C + c) : V::zero();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          V::fma(acc, e[u], t[u]);
          if (WITH_NEG) V::fma(acc_neg, en[u], t[u]);
        }
      }
    }
    if (live) {
      V::store(agg + r * (int64_t)C + c, acc);
      if (WITH_NEG) V::store(aggn + r * (int64_t)C + c, acc_neg);
    }
  }
  rs = warp_sum(rs);
  if (WITH_NEG) rs_neg = warp_sum(rs_neg);
  if (lane == 0) {
    rowsum[r] = rs;
    if (WITH_NEG) rsn[r] = rs_neg;
  }
}

template <int VEC>
void launch(bool with_neg, unsigned blocks, int threads, cudaStream_t st, const float* x,
            int64_t x_rows, int C, const int* ptr, const int* col, const float* val, int K,
            const float* al, const float* ar, int64_t num_rows, float* agg, float* rowsum,
            float* aggn, float* rsn) {
  if (with_neg) {
    gat_aggregate_kernel<VEC, true><<<blocks, threads, 0, st>>>(
        x, x_rows, C, ptr, col, val, K, al, ar, num_rows, agg, rowsum, aggn, rsn);
  } else {
    gat_aggregate_kernel<VEC, false><<<blocks, threads, 0, st>>>(
        x, x_rows, C, ptr, col, val, K, al, ar, num_rows, agg, rowsum, aggn, rsn);
  }
}

}  // namespace

// aggn and rsn are read only when with_neg != 0.
extern "C" int vq_gat_aggregate(const float* x, int64_t x_rows, int C, const int* ell_row,
                                const int* ell_col, const float* ell_val, int64_t S, int K,
                                const float* al, const float* ar, int64_t num_rows,
                                int with_neg, int* ptr, float* agg, float* rowsum,
                                float* aggn, float* rsn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  launch_row_offsets(ell_row, S, num_rows, ptr, st);
  const int threads = 256;  // 8 rows per block
  const unsigned blocks = (unsigned)((num_rows * 32 + threads - 1) / threads);
  const bool vec4 = C % 4 == 0 && aligned16(x) && aligned16(agg) &&
                    (!with_neg || aligned16(aggn));
  if (vec4) {
    launch<4>(with_neg != 0, blocks, threads, st, x, x_rows, C, ptr, ell_col, ell_val, K, al,
              ar, num_rows, agg, rowsum, aggn, rsn);
  } else {
    launch<1>(with_neg != 0, blocks, threads, st, x, x_rows, C, ptr, ell_col, ell_val, K, al,
              ar, num_rows, agg, rowsum, aggn, rsn);
  }
  return (int)cudaGetLastError();
}
