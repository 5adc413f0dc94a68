// Codebook lookup for out-of-batch (B') nodes on Hopper (sm_90a):
//
//   out[i, b, :] = emb_out[b, c_indices[clip(node_ids[i]), b], :]
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_vq.py:_lookup_kernel
// (lookup_branches), fused with the c_indices row gather in front of it
// (vq_gnn_tpu/nn/vq.py:447-449).  Exact mode copies the codeword bits; fast
// mode rounds them to bf16 and back, as lookup_branches(fast=True) does.
//
// What bounds it on the H100: device-memory bytes.  There is no arithmetic;
// the least traffic is the node ids, one int16 row of c_indices per node, the
// small codebook table (nb*M*K floats, 262 KB at nb=32, M=256, K=8, which
// stays in L2) and the [n, nb, K] output.
//
// Design: one thread per (node, branch) output row.  Neighbouring threads
// read neighbouring int16 entries of one c_indices row and write neighbouring
// K-float output rows, so both streams are coalesced.  The one-hot matrix
// product of the TPU kernel was a Mosaic workaround for a gather; on the
// H100 the gather is the kernel.  Node ids clip to the table like JAX's
// mode="clip", and codeword ids clip to [0, M), so nothing is read out of
// bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

template <bool FAST>
__global__ void lookup_kernel(const int16_t* __restrict__ cidx, int64_t table_rows, int nb,
                              const int64_t* __restrict__ node_ids, int64_t n,
                              const float* __restrict__ emb_out, int M, int K,
                              float* __restrict__ out) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n * nb) return;
  const int64_t i = t / nb;
  const int b = (int)(t % nb);
  const int64_t node = min64(max64(node_ids[i], 0), table_rows - 1);
  const int c = min(max((int)cidx[node * nb + b], 0), M - 1);
  const float* src = emb_out + ((int64_t)b * M + c) * K;
  float* dst = out + t * K;
  for (int k = 0; k < K; ++k) {
    const float v = __ldg(src + k);
    dst[k] = FAST ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
}

}  // namespace

extern "C" int vq_lookup(const int16_t* c_indices, int64_t table_rows, int nb,
                         const int64_t* node_ids, int64_t n, const float* emb_out, int M,
                         int K, int fast, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = n * nb;
  if (total <= 0) return (int)cudaGetLastError();
  if (table_rows < 1 || M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (fast) {
    lookup_kernel<true><<<blocks, 256, 0, st>>>(c_indices, table_rows, nb, node_ids, n,
                                                emb_out, M, K, out);
  } else {
    lookup_kernel<false><<<blocks, 256, 0, st>>>(c_indices, table_rows, nb, node_ids, n,
                                                 emb_out, M, K, out);
  }
  return (int)cudaGetLastError();
}
