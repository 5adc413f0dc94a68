// Codebook lookup for out-of-batch (B') nodes on Hopper (sm_90a):
//
//   out[i, b, :] = emb_out[b, clip(c_indices[clip(node_ids[i]), b], 0, M-1), :]
//
// or, split at D, the two halves apart, each contiguous:
//
//   feats[i, b*D + k]           = out[i, b, k]      (k < D)
//   grads[i, b*(K-D) + k - D]   = out[i, b, k]      (k >= D)
//
// Replaces the TPU kernel vq_gnn_tpu/ops/pallas_vq.py:_lookup_kernel
// (lookup_branches), fused with the c_indices row gather in front of it
// (vq_gnn_tpu/nn/vq.py:447-449) and, split, with the slices of the table
// into features and gradients behind it (vq.py:483-484, which XLA fuses).
// Exact mode copies the codeword bits; fast mode rounds them to bf16 and
// back, as lookup_branches(fast=True) does.
//
// What bounds it on the H100: device-memory bytes, and almost all of them
// are the output's writes.  There is no arithmetic; the least traffic is the
// node ids, one int16 row of c_indices per node, the small codebook table
// (nb*M*K floats, 262 KB at nb=32, M=256, K=8, which stays in L2) and the
// n*nb*K output floats.
//
// Design:
// - a warp per node, two nodes a warp in flight: each node id is read once
//   (a broadcast load), lane b reads c_indices[node, b] (one coalesced
//   64-byte row at nb = 32; branches past 32 in further rounds of 32);
// - a node's output is one contiguous run of nb*W floats per half (W = K
//   whole, D and K-D split).  Lane j writes the j-th 16-byte piece of that
//   run, and j + 32, ..., taking the codeword of the branch that owns it
//   from a shuffle and reading it from the L2-resident table: one coalesced
//   512-byte store a warp instruction.  A piece lies inside one codeword
//   row when W % 4 == 0 (K = 8, D = 4: a float4 load too where the table
//   rows are 16-byte aligned); otherwise (W = 5 or 9) lane j writes floats
//   j, j + 32, ...: still one coalesced 128-byte store a warp instruction;
// - the stores stream (evict-first), so the output, larger than L2, does
//   not push the table and c_indices out of it; with them two nodes a warp
//   beat one and four (PERF.md section 6);
// - writing the two halves where the step reads them spares the two copies
//   that slicing [n, nb, K] into features and gradients costs;
// - node ids clip to the table like JAX's mode="clip", and codeword ids clip
//   to [0, M), so nothing is read out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNodesPerWarp = 2;
constexpr unsigned kFull = 0xffffffffu;

// One output: the K-range [k0, k0 + W) of each branch's codeword row, nb*W
// contiguous floats per node.
struct Part {
  float* out;
  int k0, W;
  int vec4;   // 16-byte pieces: W % 4 == 0 and out 16-byte aligned
  int load4;  // and each piece one float4 load: K % 4 == 0, k0 % 4 == 0, table aligned
};

struct Args {
  const int16_t* cidx;
  int64_t table_rows;
  int nb;
  const int64_t* node_ids;
  int64_t n;
  const float* emb;  // [nb, M, K]
  int M, K;
  Part part[2];
  int nparts;
};

template <bool FAST>
__device__ __forceinline__ float rnd(float v) {
  return FAST ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool FAST>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<FAST>(v.x), rnd<FAST>(v.y), rnd<FAST>(v.z), rnd<FAST>(v.w));
}

template <bool FAST, int NPW>
__global__ void __launch_bounds__(kThreads) lookup_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t i0 = (blockIdx.x * (int64_t)kThreads + threadIdx.x) / 32 * NPW;
  if (i0 >= a.n) return;  // the whole warp leaves together
  int64_t node[NPW];
#pragma unroll
  for (int u = 0; u < NPW; ++u) {
    node[u] = -1;
    if (i0 + u < a.n) {
      const int64_t id = __ldg(reinterpret_cast<const long long*>(a.node_ids) + i0 + u);
      node[u] = id < 0 ? 0 : (id >= a.table_rows ? a.table_rows - 1 : id);
    }
  }
  for (int g = 0; g < a.nb; g += 32) {  // branches [g, g + nbg), one a lane
    const int nbg = min(32, a.nb - g);
    int cw[NPW];
#pragma unroll
    for (int u = 0; u < NPW; ++u) {
      cw[u] = 0;
      if (node[u] >= 0 && lane < nbg) {
        cw[u] = min(max((int)__ldg(a.cidx + node[u] * a.nb + g + lane), 0), a.M - 1);
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {  // unrolled: each Part stays in the parameter space
      if (p >= a.nparts) break;
      const Part& P = a.part[p];
      const float* tab = a.emb + (int64_t)g * a.M * a.K + P.k0;
      const int unit = P.vec4 ? 4 : 1;  // floats a lane writes at once
      const int units = nbg * P.W / unit;
      for (int q0 = 0; q0 < units; q0 += 32) {  // the same trip count in every lane
        const int f = (q0 + lane) * unit;        // the first float of this lane's piece
        const bool on = q0 + lane < units;
        const int b = min(f / P.W, nbg - 1);
        const int k = f - b * P.W;
#pragma unroll
        for (int u = 0; u < NPW; ++u) {
          const int c = __shfl_sync(kFull, cw[u], b);
          if (!on || node[u] < 0) continue;
          const float* src = tab + ((int64_t)b * a.M + c) * a.K + k;
          float* dst = P.out + ((i0 + u) * a.nb + g) * P.W + f;
          if (P.vec4) {
            const float4 v = P.load4 ? __ldg(reinterpret_cast<const float4*>(src))
                                     : make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2),
                                                   __ldg(src + 3));
            __stcs(reinterpret_cast<float4*>(dst), rnd4<FAST>(v));
          } else {
            __stcs(dst, rnd<FAST>(__ldg(src)));
          }
        }
      }
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

Part make_part(float* out, int k0, int W, int K, const float* emb) {
  const int vec4 = W % 4 == 0 && aligned16(out);
  return Part{out, k0, W, vec4, vec4 && K % 4 == 0 && k0 % 4 == 0 && aligned16(emb)};
}

}  // namespace

// split == 0: out0 is [n, nb, K].  0 < split < K: out0 is [n, nb*split] (the
// first split floats of each codeword row), out1 [n, nb*(K - split)] (the rest).
extern "C" int vq_lookup(const int16_t* c_indices, int64_t table_rows, int nb,
                         const int64_t* node_ids, int64_t n, const float* emb_out, int M,
                         int K, int fast, int split, float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || nb <= 0) return (int)cudaGetLastError();
  if (table_rows < 1 || M < 1 || K < 1 || split < 0 || split >= K) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{c_indices, table_rows, nb, node_ids, n, emb_out, M, K, {}, 1};
  if (split == 0) {
    a.part[0] = make_part(out0, 0, K, K, emb_out);
  } else {
    a.part[0] = make_part(out0, 0, split, K, emb_out);
    a.part[1] = make_part(out1, split, K - split, K, emb_out);
    a.nparts = 2;
  }
  const int64_t warps = (n + kNodesPerWarp - 1) / kNodesPerWarp;
  const unsigned blocks = (unsigned)((warps * 32 + kThreads - 1) / kThreads);
  if (fast) {
    lookup_kernel<true, kNodesPerWarp><<<blocks, kThreads, 0, st>>>(a);
  } else {
    lookup_kernel<false, kNodesPerWarp><<<blocks, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
