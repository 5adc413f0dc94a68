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
// for every row s < num_rows (the B' rows carry logits too, so d_al is
// needed for all of them; dx_agg is computed for all of them as well).
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
// What bounds it on the H100: device-memory bytes.  A cell costs an exp, a
// dot over C and one multiply-add per channel; the least traffic is x,
// g_agg, g_rowsum, al, ar, the transposed ELL arrays and the two outputs once
// each.  The kernel reads a 4*C-byte row of g_agg per non-zero cell, which L2
// catches only in part.
//
// Design:
// - one warp per transposed row s; x[s] and the dx_agg accumulator live in
//   the warp's slice of shared memory (2*C floats), so one kernel covers every
//   C up to the shared-memory limit and each g_agg row is read once per cell
//   for both the dot and the dx update;
// - the warp walks its row's cells 32 at a time: each lane forms a, ev, the
//   slope and g_rowsum of one cell; the warp then streams each cell's g_agg
//   row (four cells in flight), forms the dot with a warp reduction, and the
//   lane that owns the cell keeps g_ev; d_al is the warp sum of those lanes'
//   g_ev * ev * slope;
// - each output row is written once by its warp: no atomics, deterministic;
// - padding: as gat_aggregate.cu (rows >= num_rows dropped, val == 0 cells
//   skipped, columns clamp to the last row of g_agg).

#include "ell_common.cuh"

namespace {

constexpr float kNegSlope = 0.2f;  // PyG GATConv default
constexpr int kUnroll = 4;  // g_agg rows in flight per lane
constexpr int kWarps = 4;  // rows per block

template <int VEC>
__global__ void gat_backward_kernel(const float* __restrict__ x, int C, int Cs,
                                    const int* __restrict__ ptr,
                                    const int* __restrict__ col,
                                    const float* __restrict__ val, int K,
                                    const float* __restrict__ g,
                                    const float* __restrict__ g_rs,
                                    const float* __restrict__ ar, int64_t g_rows,
                                    const float* __restrict__ al, int64_t num_rows,
                                    float* __restrict__ dx, float* __restrict__ dal) {
  using V = Vec<VEC>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= num_rows) return;  // whole warp leaves; no block-wide barrier below
  float* xs = reinterpret_cast<float*>(smem4) + (size_t)warp * 2 * Cs;  // x[r]
  float* ds = xs + Cs;  // dx_agg[r] accumulator
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
    V::store(xs + c, V::load(x + r * (int64_t)C + c));
    V::store(ds + c, V::zero());
  }
  __syncwarp();

  const int64_t c0 = (int64_t)ptr[r] * K;  // cell range of this row
  const int64_t c1 = (int64_t)ptr[r + 1] * K;
  const int last = (int)(g_rows - 1);
  const float al_r = al[r];
  float dal_acc = 0.f;  // this lane's share of d_al[r]

  for (int64_t base = c0; base < c1; base += 32) {
    const int64_t cell = base + lane;
    int my_d = 0;
    float my_ev = 0.f, my_slope = 0.f, my_grs = 0.f;
    if (cell < c1) {
      const float v = val[cell];
      if (v != 0.f) {
        my_d = min(max(col[cell], 0), last);
        const float a = al_r + ar[my_d];
        my_ev = expf(a >= 0.f ? a : kNegSlope * a) * v;
        my_slope = a > 0.f ? 1.f : kNegSlope;
        my_grs = g_rs[my_d];
      }
    }
    float my_gdot = 0.f;  // <g_agg[d], x[r]> of this lane's cell
    const int n = (int)min64(32, c1 - base);
    for (int j = 0; j < n; j += kUnroll) {
      int d[kUnroll];
      float e[kUnroll], p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u;
        const float ee = __shfl_sync(0xffffffffu, my_ev, jj & 31);
        d[u] = __shfl_sync(0xffffffffu, my_d, jj & 31);
        e[u] = jj < n ? ee : 0.f;
        p[u] = 0.f;
      }
      for (int c = lane * VEC; c < C; c += 32 * VEC) {
        const typename V::T xv = V::ld(xs + c);
        typename V::T acc = V::ld(ds + c);
        typename V::T t[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          t[u] = e[u] != 0.f ? V::load(g + (int64_t)d[u] * C + c) : V::zero();
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] += V::dot(t[u], xv);
          V::fma(acc, e[u], t[u]);
        }
        V::store(ds + c, acc);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float s = warp_sum(p[u]);
        if (lane == j + u) my_gdot = s;
      }
    }
    dal_acc += (my_gdot + my_grs) * my_ev * my_slope;
  }
  __syncwarp();
  for (int c = lane * VEC; c < C; c += 32 * VEC) V::store(dx + r * (int64_t)C + c, V::ld(ds + c));
  dal_acc = warp_sum(dal_acc);
  if (lane == 0) dal[r] = dal_acc;
}

}  // namespace

// Shared memory per block: kWarps * 2 * round_up(C, 4) floats.
extern "C" int64_t vq_gat_backward_smem_bytes(int C) {
  return (int64_t)kWarps * 2 * ((C + 3) / 4 * 4) * (int64_t)sizeof(float);
}

extern "C" int vq_gat_backward(const float* x, int C, const int* t_row, const int* t_col,
                               const float* t_val, int64_t St, int K, const float* g,
                               const float* g_rs, const float* ar, int64_t g_rows,
                               const float* al, int64_t num_rows, int* ptr, float* dx,
                               float* dal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || C <= 0) return (int)cudaGetLastError();
  launch_row_offsets(t_row, St, num_rows, ptr, st);
  const int Cs = (C + 3) / 4 * 4;
  const size_t smem = (size_t)vq_gat_backward_smem_bytes(C);
  const unsigned blocks = (unsigned)((num_rows + kWarps - 1) / kWarps);
  const bool vec4 = C % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  cudaError_t err = cudaSuccess;
  if (vec4) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gat_backward_kernel<4>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gat_backward_kernel<4><<<blocks, kWarps * 32, smem, st>>>(
        x, C, Cs, ptr, t_col, t_val, K, g, g_rs, ar, g_rows, al, num_rows, dx, dal);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gat_backward_kernel<1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gat_backward_kernel<1><<<blocks, kWarps * 32, smem, st>>>(
        x, C, Cs, ptr, t_col, t_val, K, g, g_rs, ar, g_rows, al, num_rows, dx, dal);
  }
  return (int)cudaGetLastError();
}
