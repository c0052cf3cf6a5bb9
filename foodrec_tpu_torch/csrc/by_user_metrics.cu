// Hand-written Hopper kernel: the by-user evaluation metrics of a block of
// users in one launch (AUC, Recall@10/20, NDCG@10/20 per user).
//
// Replaces no TPU kernel. The JAX package computes these metrics in jnp
// (foodrec_tpu/engine/evaluator.py:30 `by_user_metrics`), which XLA fuses
// into the block's one dispatch. Ported op for op to PyTorch
// (engine/evaluator.py `by_user_metrics_plain`, the plain version that
// the CPU takes), the same arithmetic is some 110 eager launches a block:
// several [B, C, C] boolean tensors for the AUC (105 MB each at 256 x 640),
// a sort for the ranks, and a column loop for the gain sums. This kernel is
// the whole function in one launch.
//
// Bound: bytes. The compulsory traffic is the block's scores, B * C * 4
// bytes (655 KB at 256 x 640: 0.20 us at 3.35 TB/s), plus n_pos and n_cand
// (8 bytes a user each) and the [B, 5] output. The work, n_pos * C compares
// a user for the AUC and as many for the ranks, is a few hundred thousand
// integer and float operations a block. So at these sizes the kernel is
// bound by its launch and by the latency of one pass over the row, and its
// design keeps to one pass: each row is read from device memory once,
// with coalesced loads, into shared memory, and everything else happens
// there.
//
// Design. One block of kThreads threads per user row:
//   * stage the row's C scores in shared memory, and beside them the
//     total-order keys bits ^ ((bits >> 31) & 0x7fffffff) that
//     `descending_order` sorts, a masked slot (j >= n_cand) carrying the
//     key of the plain version's NEG_INF;
//   * a warp per positive i < n_pos counts, over its lanes, the negatives
//     j in [n_pos, n_cand) with s[j] < s[i] (raw scores, IEEE strict <: NaN
//     compares false, -0.0 is not below +0.0, as the plain version's
//     broadcast compare), and the rank r_i = #{j : key_j > key_i, or
//     key_j == key_i and j < i}, i's place in the stable descending sort;
//     a warp reduce sums both, the count into the warp's own slot and a
//     rank under 20 marks hit[r_i];
//   * one thread adds the warps' counts as integers and sums DCG@k and
//     IDCG@k left to right over ranks 0..k-1 with the gains table the
//     wrapper computes on the host, as `_sum_left_to_right` does; a miss
//     adds 0.0, which changes no sum. The divisions are IEEE (no fast
//     math). So every output equals the plain version's bit for bit.
// A row has to fit in shared memory (8 bytes a slot); the wrapper
// (ops/_kernels.py) raises on a wider one.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxK = 20;   // Recall and NDCG at 10 and 20
constexpr int kOut = 5;     // auc, recall@10, recall@20, ndcg@10, ndcg@20

struct Gains {
  float g[kMaxK];           // 1 / log2(rank + 2), float32, from the host
};

__device__ __forceinline__ int32_t order_key(float v) {
  const int32_t bits = __float_as_int(v);
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
by_user_metrics_rows(const float* __restrict__ scores,
                     const int64_t* __restrict__ n_pos,
                     const int64_t* __restrict__ n_cand,
                     float* __restrict__ out, int c, long long neg_num,
                     int32_t masked_key, Gains gains) {
  extern __shared__ float s_score[];                         // [c]
  int32_t* s_key = reinterpret_cast<int32_t*>(s_score + c);  // [c]
  __shared__ long long s_below[kWarps];
  __shared__ int s_hit[kMaxK];

  const int row = blockIdx.x;
  const int64_t np = n_pos[row];
  const int pos_end = static_cast<int>(np < 0 ? 0 : (np < c ? np : c));
  const int64_t nc = n_cand[row];
  const int cand_end = static_cast<int>(nc < 0 ? 0 : (nc < c ? nc : c));
  const float* in = scores + static_cast<int64_t>(row) * c;
  for (int j = threadIdx.x; j < c; j += kThreads) {
    const float v = in[j];
    s_score[j] = v;
    s_key[j] = j < cand_end ? order_key(v) : masked_key;
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x < kMaxK) s_hit[threadIdx.x] = 0;
  if (lane == 0) s_below[warp] = 0;
  __syncthreads();

  long long below_total = 0;  // lane 0's running count of its warp
  for (int i = warp; i < pos_end; i += kWarps) {
    const float si = s_score[i];
    const int32_t ki = s_key[i];
    int below = 0, ahead = 0;
    for (int j = lane; j < c; j += kWarp) {
      const int32_t kj = s_key[j];
      below += j >= pos_end && j < cand_end && s_score[j] < si;
      ahead += kj > ki || (kj == ki && j < i);
    }
    below = warp_sum(below);
    ahead = warp_sum(ahead);
    if (lane == 0) {
      below_total += below;
      if (ahead < kMaxK) s_hit[ahead] = 1;  // ranks of positives are distinct
    }
  }
  if (lane == 0) s_below[warp] = below_total;
  __syncthreads();
  if (threadIdx.x != 0) return;

  long long count = 0;
  for (int w = 0; w < kWarps; ++w) count += s_below[w];
  const long long np1 = np > 1 ? np : 1;
  float dcg[2] = {0.0f, 0.0f}, idcg[2] = {0.0f, 0.0f};
  long long hits[2] = {0, 0};
  const int ks[2] = {10, 20};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const long long ideal_end = np < ks[q] ? np : ks[q];
    for (int r = 0; r < ks[q]; ++r) {
      dcg[q] = __fadd_rn(dcg[q], s_hit[r] ? gains.g[r] : 0.0f);
      idcg[q] = __fadd_rn(idcg[q], r < ideal_end ? gains.g[r] : 0.0f);
      hits[q] += s_hit[r];
    }
  }
  float* o = out + static_cast<int64_t>(row) * kOut;
  o[0] = __fdiv_rn(__ll2float_rn(count), __ll2float_rn(np1 * neg_num));
  o[1] = __fdiv_rn(__ll2float_rn(hits[0]), __ll2float_rn(np1));
  o[2] = __fdiv_rn(__ll2float_rn(hits[1]), __ll2float_rn(np1));
  o[3] = __fdiv_rn(dcg[0], fmaxf(idcg[0], 1e-12f));
  o[4] = __fdiv_rn(dcg[1], fmaxf(idcg[1], 1e-12f));
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller (ops/_kernels.py) has checked that scores is a contiguous float32
// [b, c] and n_pos, n_cand contiguous int64 [b] on one device, out a
// float32 [b, 5] there, b > 0, 20 <= c and 8 * c bytes within the shared
// memory a block may use. `gains` points to kMaxK float32 values in host
// memory, read before this returns; `masked_key` is the order key of the
// score a masked slot takes.
extern "C" int by_user_metrics_f32(const void* scores, const void* n_pos,
                                   const void* n_cand, const void* gains,
                                   void* out, long long b, long long c,
                                   long long neg_num, int masked_key,
                                   void* stream) {
  Gains g;
  for (int r = 0; r < kMaxK; ++r) g.g[r] = static_cast<const float*>(gains)[r];
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        by_user_metrics_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  by_user_metrics_rows<<<static_cast<unsigned>(b), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int64_t*>(n_pos),
      static_cast<const int64_t*>(n_cand), static_cast<float*>(out),
      static_cast<int>(c), neg_num, static_cast<int32_t>(masked_key), g);
  return static_cast<int>(cudaGetLastError());
}
