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
// fast != 0 rounds xn and emb to bf16 before the dot product and xn to bf16
// in the sums, with f32 accumulation, as the Pallas fast mode does; e2 stays
// the f32 norm of the unrounded codebook, computed by the caller.
//
// What bounds it on the H100: arithmetic.  2*nb*B*M*K multiply-adds against
// ~(nb*B*K*4) bytes of input: at nb=32, B=86k, M=256, K=8 that is 11 GFLOP
// over ~100 MB, above the f32 machine balance.  This first version runs the
// distances on the f32 CUDA cores (not the tensor cores), so it sits well
// above the bf16 bound in fast mode.
//
// Design:
// - one block per (tile of ROWS batch rows, branch); the [M, K] codebook and
//   its norms sit in shared memory (8 KB at M=256, K=8) and every thread
//   reads the same codeword at once (a broadcast);
// - each thread scans all M codewords in ascending order for its rows with a
//   strict '<', which keeps the first minimum.  The dot product is a chain
//   of separately rounded multiplies and adds (__fmul_rn/__fadd_rn, no FMA
//   contraction), the same arithmetic as the plain PyTorch version, so the
//   two agree bit for bit on the card;
// - invalid rows get an idx but add nothing (the Pallas kernel's redirect to
//   the out-of-range index M);
// - statistics are deterministic: within a block, thread m sums the rows
//   assigned to codeword m in row order from shared memory; a second kernel
//   adds the per-block partials in block order.  No atomics, so the EMA state
//   that carries these sums from step to step does not drift run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int kMaxK = 17;  // 2*D + 1 for D <= 8
constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// KT > 0: K known at compile time; KT == 0: runtime K <= kMaxK.
template <int KT, bool FAST, bool SMEM_CB>
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
    for (int i = threadIdx.x; i < M * K; i += blockDim.x) {
      const float e = emb_b[i];
      emb_s[i] = FAST ? bf16_round(e) : e;
    }
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
          const float v = xr[k];
          x[k] = FAST ? bf16_round(v) : v;
          x_s[(size_t)r * K + k] = x[k];
        }
      }
      float best = 0.f;
      int bi = 0;
      for (int m = 0; m < M; ++m) {
        const float* e = cb + (size_t)m * K;
        float ek0 = SMEM_CB ? e[0] : (FAST ? bf16_round(__ldg(e)) : __ldg(e));
        float acc = __fmul_rn(x[0], ek0);
#pragma unroll
        for (int k = 1; k < (KT > 0 ? KT : kMaxK); ++k) {
          if (k < K) {
            const float ek = SMEM_CB ? e[k] : (FAST ? bf16_round(__ldg(e + k)) : __ldg(e + k));
            acc = __fadd_rn(acc, __fmul_rn(x[k], ek));
          }
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

// counts[b, m] / sums[b, m, k] = sum over blocks, in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nb, int nblk, int M,
                                       int K, float* __restrict__ counts,
                                       float* __restrict__ sums) {
  const int64_t per = (int64_t)M * (K + 1);
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= nb * per) return;
  const int64_t b = t / per, rem = t % per;
  float acc = 0.f;
  for (int blk = 0; blk < nblk; ++blk) acc += part[((int64_t)b * nblk + blk) * per + rem];
  const int64_t m = rem / (K + 1);
  const int j = (int)(rem % (K + 1));
  if (j == 0) {
    counts[b * M + m] = acc;
  } else {
    sums[(b * M + m) * K + (j - 1)] = acc;
  }
}

template <int KT, bool FAST, bool SMEM_CB>
cudaError_t launch(const float* xn, const float* emb, const float* e2, const uint8_t* valid,
                   int nb, int64_t B, int M, int K, int rows, int nblk, int* idx, float* part,
                   size_t smem, cudaStream_t st) {
  auto kern = assign_kernel<KT, FAST, SMEM_CB>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)nblk, (unsigned)nb), kThreads, smem, st>>>(xn, emb, e2, valid, B, M, K,
                                                                   rows, idx, part);
  return cudaGetLastError();
}

template <bool FAST, bool SMEM_CB>
cudaError_t dispatch_k(const float* xn, const float* emb, const float* e2,
                       const uint8_t* valid, int nb, int64_t B, int M, int K, int rows,
                       int nblk, int* idx, float* part, size_t smem, cudaStream_t st) {
  switch (K) {
    case 4:
      return launch<4, FAST, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part,
                                      smem, st);
    case 8:
      return launch<8, FAST, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part,
                                      smem, st);
    default:
      return launch<0, FAST, SMEM_CB>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx, part,
                                      smem, st);
  }
}

}  // namespace

// part: scratch of nb * ceil(B / rows) * M * (K + 1) floats.
extern "C" int vq_assign_stats(const float* xn, const float* emb, const float* e2,
                               const uint8_t* valid, int nb, int64_t B, int M, int K, int fast,
                               int rows, float* part, int* idx, float* counts, float* sums,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || M < 1 || nb < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const int nblk = (int)((B + rows - 1) / rows);
  if (nblk > 0) {
    const size_t tile = (size_t)rows * K * sizeof(float) + (size_t)rows * sizeof(int);
    const size_t cb = (size_t)M * (K + 1) * sizeof(float);
    const bool smem_cb = tile + cb <= 200 * 1024;
    const size_t smem = smem_cb ? tile + cb : tile;
    cudaError_t e;
    if (fast) {
      e = smem_cb ? dispatch_k<true, true>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx,
                                           part, smem, st)
                  : dispatch_k<true, false>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx,
                                            part, smem, st);
    } else {
      e = smem_cb ? dispatch_k<false, true>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx,
                                            part, smem, st)
                  : dispatch_k<false, false>(xn, emb, e2, valid, nb, B, M, K, rows, nblk, idx,
                                             part, smem, st);
    }
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t total = (int64_t)nb * M * (K + 1);
  reduce_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, nb, nblk, M, K,
                                                                         counts, sums);
  return (int)cudaGetLastError();
}
